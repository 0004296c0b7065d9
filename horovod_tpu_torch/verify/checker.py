"""Bounded explicit-state model checker.

Counterpart of ``horovod_tpu/verify/checker.py``, carried over as it is.

Breadth-first exploration of a spec's reachable states up to a depth
bound, checking every invariant on every new state. BFS (not DFS) so the
first counterexample found for an invariant is a *shortest* one — the
traces printed for seeded historical bugs read like minimal
reproductions, not 40-step rambles.

The visited set deduplicates states reached by different interleavings
(the usual explicit-state reduction), and parent pointers reconstruct
the action sequence from the initial state for counterexample printing.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Violation:
    spec: str
    invariant: str
    doc: str
    trace: List[str]          # action labels, initial state -> violation
    state: object

    def render(self) -> str:
        lines = [f"INVARIANT VIOLATED: {self.invariant} ({self.spec})",
                 f"  {self.doc}",
                 f"  counterexample ({len(self.trace)} events):"]
        for i, label in enumerate(self.trace, 1):
            lines.append(f"    {i:2d}. {label}")
        # NamedTuple repr names every field, so the violated predicate
        # can be checked by eye against the final state
        lines.append(f"  final state: {self.state!r}")
        return "\n".join(lines)


@dataclass
class CheckResult:
    spec: str
    states: int = 0
    transitions: int = 0
    depth_reached: int = 0
    truncated: bool = False   # hit the depth or state cap before closure
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        status = "OK" if self.ok else \
            f"{len(self.violations)} violation(s)"
        extra = " (bounded)" if self.truncated else " (exhaustive)"
        return (f"{self.spec}: {status} — {self.states} states, "
                f"{self.transitions} transitions, depth "
                f"{self.depth_reached}{extra}")


def check(spec, depth: int = 24, max_states: int = 200_000,
          max_violations: int = 1) -> CheckResult:
    """Explore ``spec`` exhaustively to ``depth``; stop early after
    ``max_violations`` counterexamples (0 = collect all found at the
    violating depth). ``truncated`` is False only when the full reachable
    state space closed under the bounds — the "exhaustive at the CI depth
    bound" claim the Makefile target asserts."""
    res = CheckResult(spec=spec.name)
    init = spec.initial()
    # state -> (parent_state, action_label); init has no parent
    parents: Dict[object, Optional[Tuple[object, str]]] = {init: None}
    frontier = deque([(init, 0)])
    res.states = 1
    invs = spec.invariants

    def trace_to(state) -> List[str]:
        labels: List[str] = []
        cur = state
        while parents[cur] is not None:
            cur, label = parents[cur]
            labels.append(label)
        return labels[::-1]

    def violated(state) -> bool:
        hit = False
        for inv in invs:
            if not inv.check(state):
                res.violations.append(Violation(
                    spec=spec.name, invariant=inv.name, doc=inv.doc,
                    trace=trace_to(state), state=state))
                hit = True
        return hit

    if violated(init) and max_violations and \
            len(res.violations) >= max_violations:
        return res

    while frontier:
        state, d = frontier.popleft()
        res.depth_reached = max(res.depth_reached, d)
        if d >= depth:
            res.truncated = True
            continue
        for label, succ in spec.actions(state):
            res.transitions += 1
            if succ in parents:
                continue
            parents[succ] = (state, label)
            res.states += 1
            if violated(succ) and max_violations and \
                    len(res.violations) >= max_violations:
                return res
            if res.states >= max_states:
                res.truncated = True
                return res
            frontier.append((succ, d + 1))
    return res
