"""``python -m horovod_tpu_torch.verify`` — explicit-state protocol model
checker + conformance (the port's ``hvd-check``).

Usage::

    python -m horovod_tpu_torch.verify       # all specs, CI bound
    python -m horovod_tpu_torch.verify --spec epoch --depth 40
    python -m horovod_tpu_torch.verify --mutant epoch_accept_stale_notify
                                      # seeded bug: expects a counterexample
    python -m horovod_tpu_torch.verify --conformance DIR
                                      # replay flight dumps + KV WALs
                                      #   + event journals
    python -m horovod_tpu_torch.verify --list-specs / --list-mutants

Counterpart of ``horovod_tpu/verify/cli.py`` over the port's specs.

Exit status: 0 clean, 1 invariant violations / divergences found, 2
usage error. ``--mutant`` still exits 1 on a violation — the seeded-bug
tests assert the nonzero exit, so the CLI's contract stays one-valued:
"did the checker find something".
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from horovod_tpu_torch.verify import conformance
from horovod_tpu_torch.verify.checker import check
from horovod_tpu_torch.verify.specs import MUTANTS, SPECS, make_spec

# The CI profile (tests/test_torch_verify.py, chip_smoke.py's check
# phase): deep enough that every spec's reachable space closes (depths
# observed: 3-31),
# bounded so a runaway spec edit fails fast instead of eating the tier-1
# budget.
CI_DEPTH = 32
CI_MAX_STATES = 200_000


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.verify",
        description="explicit-state model checker + runtime trace "
                    "conformance for the horovod_tpu_torch control plane")
    p.add_argument("--spec", choices=sorted(SPECS),
                   help="check one spec (default: all)")
    p.add_argument("--mutant", choices=sorted(MUTANTS),
                   help="re-introduce a seeded historical bug and hunt "
                        "for its counterexample")
    p.add_argument("--depth", type=int, default=CI_DEPTH,
                   help=f"exploration depth bound (default {CI_DEPTH})")
    p.add_argument("--max-states", type=int, default=CI_MAX_STATES,
                   help="state-count safety cap")
    p.add_argument("--all-violations", action="store_true",
                   help="keep exploring after the first counterexample")
    p.add_argument("--conformance", metavar="DIR",
                   help="replay artifacts (flight_rank*.json dumps, KV "
                        "wal.log/snapshot.json, journal_*.log event "
                        "journals) under DIR against the protocol rules")
    p.add_argument("--kv-dir", help="explicit KV directory for "
                                    "--conformance")
    p.add_argument("--flight-dir", help="explicit flight-dump directory "
                                        "for --conformance")
    p.add_argument("--journal-dir", help="explicit event-journal "
                                         "directory for --conformance")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--list-specs", action="store_true")
    p.add_argument("--list-mutants", action="store_true")
    args = p.parse_args(argv)

    if args.list_specs:
        for name, cls in sorted(SPECS.items()):
            doc = (cls.__doc__ or "").strip().splitlines()[0]
            print(f"{name:12s} {doc}")
        return 0
    if args.list_mutants:
        for name, (spec, _kwarg, doc) in sorted(MUTANTS.items()):
            print(f"{name:30s} [{spec}] {doc}")
        return 0

    if args.conformance:
        report = conformance.check_artifacts(
            args.conformance, kv_dir=args.kv_dir,
            flight_dir=args.flight_dir, journal_dir=args.journal_dir)
        if args.as_json:
            print(json.dumps(report, indent=2))
        else:
            for line in report["checked"]:
                print(f"checked {line} ({report['records'][line]} "
                      "records)")
            for line in report["divergences"]:
                print(f"DIVERGENCE: {line}")
            print(f"hvd-check conformance: {len(report['checked'])} "
                  f"artifact set(s), {len(report['divergences'])} "
                  "divergence(s)")
        return 1 if report["divergences"] else 0

    if args.mutant:
        specs = [make_spec(MUTANTS[args.mutant][0], mutant=args.mutant)]
    elif args.spec:
        specs = [make_spec(args.spec)]
    else:
        specs = [make_spec(name) for name in sorted(SPECS)]

    results = [check(s, depth=args.depth, max_states=args.max_states,
                     max_violations=0 if args.all_violations else 1)
               for s in specs]
    violations = [v for r in results for v in r.violations]

    if args.as_json:
        print(json.dumps({
            "results": [{
                "spec": r.spec, "states": r.states,
                "transitions": r.transitions, "depth": r.depth_reached,
                "exhaustive": not r.truncated,
                "violations": [{
                    "invariant": v.invariant, "doc": v.doc,
                    "trace": v.trace} for v in r.violations],
            } for r in results]}, indent=2))
    else:
        for r in results:
            print(r.summary())
        for v in violations:
            print()
            print(v.render())
        if args.mutant and violations:
            print(f"\nseeded bug `{args.mutant}` reproduced: "
                  f"{MUTANTS[args.mutant][2]}")
        elif args.mutant:
            print(f"\nWARNING: seeded bug `{args.mutant}` produced NO "
                  "counterexample — the invariant guarding it has lost "
                  "its teeth", file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
