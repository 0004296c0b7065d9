"""The yardstick's arithmetic: model FLOPs of a training step from the
configuration's shapes, the least time of each flash kernel from its shapes,
and the H100's published peaks.

Frozen here so that no change to the program can move it: ``attention_pairs``
and ``kernel_bounds`` are copies of ``horovod_tpu_torch/profiler/flops.py``
``attention_pairs`` and ``chip_smoke.py`` ``bounds``.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# the cards whose peaks these are, by the name CUDA reports
PEAK_CARDS = ("NVIDIA H100 80GB HBM3",)


def peak_flops(card: str, dtype_name: str) -> Optional[float]:
    """The dense peak FLOP/s of ``card`` in ``dtype_name``; None for a card
    whose peak this table does not know."""
    return PEAK_FLOPS.get(dtype_name) if card in PEAK_CARDS else None


def attention_pairs(tq: int, tk: int, causal: bool, q_off: float = 0.0,
                    k_off: float = 0.0) -> int:
    """(q, k) pairs of one head that the attention needs: all ``tq * tk``,
    or under ``causal`` those whose global key position ``k_off + j`` does
    not exceed the query's ``q_off + i``."""
    if not causal:
        return tq * tk
    # row i sees min(max(i + shift, 0), tk) keys: none before row z, all
    # from row f, i + shift in between
    shift = int(q_off - k_off) + 1
    z = min(max(1 - shift, 0), tq)
    f = min(max(tk - shift, 0), tq)
    return (f - z) * (z + f - 1 + 2 * shift) // 2 + (tq - f) * tk


def forward_flops(shape: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one forward of ``batch`` sequences of ``seq`` tokens:
    2 per weight of every block's Dense layers and of the LM head per token
    (biases, norms and elementwise work not counted), plus 2 (d + dv) per
    causally visible (q, k) pair per head and layer. ``shape`` holds
    ``layers``, ``hidden``, ``heads``, ``head_dim``, ``v_head_dim``,
    ``mlp``, ``vocab`` and ``causal``."""
    h, heads = shape["hidden"], shape["heads"]
    d, dv = shape["head_dim"], shape["v_head_dim"]
    # q, k at d per head, v and the output projection at dv per head
    attn_w = h * heads * (2 * d + dv) + heads * dv * h
    block_w = attn_w + 2 * h * shape["mlp"]
    weights = shape["layers"] * block_w + shape["vocab"] * h
    pairs = attention_pairs(seq, seq, shape["causal"])
    attn = batch * heads * shape["layers"] * pairs * 2 * (d + dv)
    return 2 * weights * batch * seq + attn


def train_step_flops(shape: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step: three forwards' worth (forward,
    and a backward of twice the forward); recomputation is not counted."""
    return 3 * forward_flops(shape, batch, seq)


def kernel_bounds(b, t, h, d, causal, dtype_name, q_off=0.0, k_off=0.0,
                  dv=None) -> Dict[str, tuple]:
    """Least time (ms) per flash kernel: each input read once and each
    output written once at the memory rate, against the products this run's
    data needs (only the causally visible q-k pairs, at these offsets; each
    product at its own width, q.k^T and dS-by-q/k ones at d, those with v
    or do at dv) at the tensor-core rate. The exp and elementwise work is
    not counted. Returns name -> (ms, "bytes" | "operations", bytes,
    flops)."""
    dv = d if dv is None else dv
    esize = 4 if dtype_name == "float32" else 2
    pairs = b * h * attention_pairs(t, t, causal, q_off, k_off)
    x = b * t * h * d * esize          # one [B, T, H, d] tensor
    xv = b * t * h * dv * esize        # one [B, T, H, dv] tensor
    row = b * h * t * 4                # one [B, H, T] fp32 tensor
    work = {  # name -> (bytes, flops)
        # q, k, v in; o, lse out: q.k^T and p.v
        "flash_fwd": (2 * x + xv + xv + row, 2 * pairs * (d + dv)),
        # q, k, v, do, lse, corr in; dq out: q.k^T, do.v^T, ds.k
        "flash_bwd_dq": (2 * x + 2 * xv + 2 * row + x,
                         2 * pairs * (2 * d + dv)),
        # q, k, v, do, lse, corr in; dk, dv out: q.k^T, do.v^T, ds^T.q,
        # p^T.do
        "flash_bwd_dkv": (2 * x + 2 * xv + 2 * row + x + xv,
                          2 * pairs * (2 * d + 2 * dv)),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
    return out
