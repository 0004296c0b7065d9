"""Spec framework: states, actions, invariants.

Counterpart of ``horovod_tpu/verify/spec.py``, carried over as it is (it
is framework-free).

A spec is an explicit-state transition system small enough to enumerate:

- ``initial()`` returns the (hashable) initial state;
- ``actions(state)`` returns the enabled transitions as
  ``[(label, successor_state), ...]`` — *every* nondeterministic choice
  (scheduling, message timing, fault injection) is an action, so the
  checker's enumeration of action interleavings IS the enumeration of
  executions;
- ``invariants`` are named safety predicates checked on every reachable
  state.

Fault injection is not a checker feature but a modeling convention:
specs carry budget counters in the state (``crashes_left`` etc.) and
expose crash/partition/drop transitions guarded by them, which makes
"faults injectable at every step" fall out of ordinary exploration.

States are ``NamedTuple``s: hashable (the visited set), immutable
(successors are fresh states), and cheap to render in counterexample
traces.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Tuple


@dataclass(frozen=True)
class Invariant:
    name: str
    doc: str
    check: Callable  # state -> bool; False = violated


@dataclass
class Spec:
    """Base class; concrete specs in ``horovod_tpu_torch/verify/specs.py``."""

    name: str = "spec"
    mutations: Tuple[str, ...] = field(default_factory=tuple)

    def initial(self):
        raise NotImplementedError

    def actions(self, state) -> Iterable[Tuple[str, object]]:
        raise NotImplementedError

    @property
    def invariants(self) -> List[Invariant]:
        raise NotImplementedError
