"""The readings that set the limits of ``correct``, apart from the
benchmark's runs.

    python -m portbench.control --workload <name> --seeds <n,n,...>

For each seed, the plain reference in float32 (what every run compares
with) against, in the program's place:

- ``control``: the same reference with every product in fp8 (the nearest
  precision below the configuration's bf16), which has to fail;
- ``half_batch``: the reference with each replica's loss over the first
  half of its rows;
- ``no_exchange`` (cells on more than one card): the reference with
  replica 0's gradient alone, as if the exchange were left out.

A step that leaves the state unchanged reads 1 on ``delta_gap`` by its
definition and needs no run. All on one card, at the cell's own sizes (a
cell's replicas one after another). Prints one JSON line per seed and
reading; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(workload: str, seeds, device=None):
    import torch

    from portbench import reference
    from portbench.cell import load_cell, reference_readings
    cell = load_cell(workload)
    dev = torch.device(device or "cuda")
    variants = [("control", "fp8", None), ("half_batch", "float32",
                                            "half_batch")]
    if cell.chips > 1:
        variants.append(("no_exchange", "float32", "no_exchange"))
    for seed in seeds:
        want = reference_readings(cell, seed, cell.chips, dev)
        for name, matmul, fault in variants:
            got = reference_readings(cell, seed, cell.chips, dev, matmul,
                                     fault)
            yield {"workload": workload, "seed": seed, "variant": name,
                   **reference.gaps(got, want)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(args.workload, seeds, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
