"""Per-step FLOPs accounting.

Counterpart of ``horovod_tpu/profiler/flops.py``. The reference asks XLA's
cost model for the FLOPs of the compiled step; PyTorch compiles nothing, so
:func:`compiled_flops` runs the function once under
``torch.utils.flop_counter.FlopCounterMode`` (``source="torch_flop_counter"``)
and counts the matrix products and convolutions it dispatches. The
reference's ``executable_flops`` (cost analysis of an already-compiled
executable) has no counterpart: there is no executable to ask.

``FlopCounterMode`` sees aten ops only. The flash-attention kernels are
ctypes launches (``ops/_build.py``), invisible to it on the card, while on
the CPU their plain versions dispatch einsums it would count. So each
kernel wrapper reports its launch through :func:`flash_launch`: the FLOPs
its visible (q, k) pairs need are added explicitly, and whatever aten
FLOPs the plain version dispatched inside the launch are taken out. The
same step then counts the same on the CPU and on the card.

The analytic models are the reference's, verbatim: the fallback when no
count can be taken.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FlopsEstimate:
    """FLOPs for one execution of a program, with provenance."""

    flops: float
    source: str  # "torch_flop_counter" | "analytic"
    detail: str = ""

    def __bool__(self) -> bool:
        return self.flops > 0


# ---------------------------------------------------------------------------
# The flash kernels' share

# The flash kernels. Each computes two products over every visible (q, k)
# pair, one at q/k's width d and one at v's width dv, 2 FLOPs per
# multiply-add: the forward q.k^T and p.v, dq dO.v^T and dS.k, dk/dv dS^T.q
# and P^T.dO. The kernels' recomputation of S (and dk/dv's second dO.v^T)
# is not model work and is not counted.
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def flash_pair_flops(d: int, dv: int) -> int:
    """Model FLOPs of one flash kernel per visible (q, k) pair, at the
    caller's widths (never a padded one)."""
    return 2 * (d + dv)


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


class _Tally:
    def __init__(self, counter):
        self.counter = counter
        self.aten_inside = 0.0  # aten FLOPs dispatched inside launches
        self.flash = {name: 0.0 for name in FLASH_KERNELS}


# the counts in progress, innermost last: module-wide, not per thread,
# since on the card the backward's launches run on autograd's own thread
_active: List[_Tally] = []


@contextlib.contextmanager
def flash_launch(name: str, q, k, v, causal: bool, q_off: float,
                 k_off: float):
    """Wraps one launch of flash kernel ``name`` (q [B, Tq, H, d], k [B, Tk,
    H, d], v [B, Tk, H, dv]): inside :func:`compiled_flops`, its model FLOPs
    are counted and the aten ops it dispatches are not; otherwise it does
    nothing."""
    if not _active:
        yield
        return
    tally = _active[-1]
    before = tally.counter.get_total_flops()
    yield
    tally.aten_inside += tally.counter.get_total_flops() - before
    b, tq, h, d = q.shape
    tally.flash[name] += flash_pair_flops(d, v.shape[-1]) * b * h * \
        attention_pairs(tq, k.shape[1], causal, q_off, k_off)


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[float, dict]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode``: (aten
    FLOPs outside the flash launches, FLOPs of each flash kernel)."""
    from torch.utils.flop_counter import FlopCounterMode
    tally = _Tally(FlopCounterMode(display=False))
    _active.append(tally)
    try:
        with tally.counter:
            fn(*args, **kwargs)
    finally:
        _active.pop()
    return tally.counter.get_total_flops() - tally.aten_inside, tally.flash


def compiled_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """FLOPs of one execution of ``fn(*args, **kwargs)``: the aten count
    plus the flash kernels' model FLOPs, or None when nothing was counted.
    ``fn`` runs once, so pass one without side effects you mind (a
    forward and backward without the optimizer's step)."""
    aten, flash = count_flops(fn, *args, **kwargs)
    total = aten + sum(flash.values())
    return float(total) if total > 0 else None


def train_step_flops(step_fn: Callable, args: tuple,
                     fallback_flops: Optional[float] = None,
                     fallback_detail: str = "") -> FlopsEstimate:
    """FLOPs of one train step: the ``FlopCounterMode`` count first (with
    the flash kernels' share named in ``detail``), analytic fallback.
    ``step_fn(*args)`` runs once (see :func:`compiled_flops`)."""
    aten, flash = count_flops(step_fn, *args)
    total = aten + sum(flash.values())
    if total > 0:
        parts = ", ".join(f"{k} {v:.6g}" for k, v in flash.items())
        return FlopsEstimate(
            float(total), "torch_flop_counter",
            f"FlopCounterMode aten ops {aten:.6g} + flash kernels "
            f"{sum(flash.values()):.6g} ({parts})")
    if fallback_flops is not None and fallback_flops > 0:
        return FlopsEstimate(float(fallback_flops), "analytic",
                             fallback_detail or "analytic per-item model")
    return FlopsEstimate(-1.0, "unavailable",
                         "no FLOPs counted and no analytic fallback")


# ---------------------------------------------------------------------------
# Analytic models (multiply-add = 2 FLOPs). These are the fallback when the
# backend's cost analysis is unavailable, and the cross-check the tests pin
# the cost-analysis path against.

# ResNet-50 forward at 224x224 is ~4.09 GFLOP/image (the standard published
# figure); training ~= 3x forward (fwd + ~2x-cost bwd).
RESNET50_FWD_FLOPS_PER_IMAGE = 4.09e9
RESNET50_PARAMS = 25.6e6

BERT_BASE_PARAMS = 110e6


def resnet50_train_flops_per_image(train: bool = True) -> float:
    """Analytic ResNet-50 FLOPs per 224x224 image."""
    mult = 3.0 if train else 1.0
    return mult * RESNET50_FWD_FLOPS_PER_IMAGE


def transformer_train_flops_per_seq(params: float, seq_len: int,
                                    train: bool = True) -> float:
    """Kaplan-style transformer accounting: ~2N FLOPs/token forward,
    ~4N backward => 6 * params per token for a train step."""
    per_token = (6.0 if train else 2.0) * params
    return per_token * seq_len


def conv2d_flops(batch: int, out_h: int, out_w: int, c_in: int, c_out: int,
                 k_h: int, k_w: int) -> float:
    """2 * MACs of a dense NHWC conv — building block for hand-computed
    expectations in tests."""
    return 2.0 * batch * out_h * out_w * c_in * c_out * k_h * k_w


def dense_flops(batch: int, d_in: int, d_out: int) -> float:
    return 2.0 * batch * d_in * d_out
