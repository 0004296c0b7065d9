"""One rank of a cell on more than one card, as the port's launcher starts
it (``portbench.run`` builds the command): the program imported, then,
once the reporting process has found the cards and built the kernels
(its ``go.json`` in ``<out>``), the rank's run, its result written to
``<out>/rank<R>.json`` for the process that reports."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench.run import GO_FILE, process_start_wall

# the longest a rank waits for the word to go (a first run builds the
# kernels meanwhile)
GO_TIMEOUT_S = 1100.0


def wait_to_go(out: str, parent: int) -> str:
    """The card's name from ``<out>/go.json``, once it is there; exits if
    the reporting process ends or the wait times out."""
    path = os.path.join(out, GO_FILE)
    deadline = time.monotonic() + GO_TIMEOUT_S
    while not os.path.exists(path):
        try:
            os.kill(parent, 0)
        except ProcessLookupError:
            sys.exit("portbench.worker: the reporting process has ended")
        if time.monotonic() > deadline:
            sys.exit("portbench.worker: no word to go")
        time.sleep(0.01)
    with open(path) as f:
        return json.load(f)["card"]


def main(argv=None) -> int:
    start = process_start_wall()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--parent", type=int, required=True)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    import torch  # noqa: F401  the imports overlap the card check
    import horovod_tpu_torch  # noqa: F401
    from portbench.cell import load_cell, run_rank
    cell = load_cell(args.workload)
    phases = {"rank_start": start, "imports": time.time()}
    card = wait_to_go(args.out, args.parent)
    phases["go"] = time.time()
    res = run_rank(cell, args.seed, args.seconds, bool(args.trace), card,
                   args.device)
    res["phases"] = {**phases, **res["phases"]}
    path = os.path.join(args.out, f"rank{res['rank']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
