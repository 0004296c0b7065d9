"""Inputs made from ``--seed``: the initial weights and the token batches.

Both are drawn on the device by a ``torch.Generator`` of that device, in a
few large calls, from sub-seeds derived from the run's seed. The program and
the reference are handed the same tensors, and the same seed gives the same
tensors on every run and on every card.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

# std of a unit normal truncated at +-2
TRUNC_STD = 0.87962566103423978


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed: distinct
    parts give unrelated seeds."""
    key = "/".join(str(p) for p in (int(seed),) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                               *parts))


def make_weights(spec: List[Tuple[str, tuple, str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """fp32 weights by leaf name from ``spec``, a list of ``(name, shape,
    init)``: ``lecun`` (flax's lecun-normal: a unit normal truncated at +-2,
    scaled to std ``fan_in^-1/2``, ``fan_in = shape[1]``), ``embed`` (a
    plain normal of std ``shape[1]^-1/2``), ``zeros`` or ``ones``. Each
    kind is drawn in one call over all of its leaves."""
    gen = generator(device, seed, "weights")
    sizes = {"lecun": 0, "embed": 0}
    for _, shape, init in spec:
        if init in sizes:
            sizes[init] += math.prod(shape)
    flat = {"lecun": torch.empty(sizes["lecun"], device=device),
            "embed": torch.empty(sizes["embed"], device=device)}
    torch.nn.init.trunc_normal_(flat["lecun"], 0.0, 1.0, -2.0, 2.0,
                                generator=gen)
    flat["embed"].normal_(0.0, 1.0, generator=gen)
    offset = {"lecun": 0, "embed": 0}
    out = {}
    for name, shape, init in spec:
        if init in flat:
            n = math.prod(shape)
            std = shape[1] ** -0.5
            if init == "lecun":
                std /= TRUNC_STD
            o = offset[init]
            out[name] = flat[init][o:o + n].view(shape).mul_(std)
            offset[init] = o + n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out


def make_ids(seed: int, rank: int, index: int, rows: int, seq: int,
             vocab: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch ``index`` of replica ``rank``: token ids and label ids, each
    ``[rows, seq]`` and uniform over the vocabulary, drawn independently."""
    gen = generator(device, seed, "batch", rank, index)
    ids = torch.randint(0, vocab, (2, rows, seq), generator=gen,
                        device=device)
    return ids[0], ids[1]
