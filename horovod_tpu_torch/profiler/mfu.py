"""Model-FLOPs-utilization accounting — the one shared calculator.

Counterpart of ``horovod_tpu/profiler/mfu.py``: the same peak table, with
the H100 SXM added, and the same arithmetic. Peaks are dense bf16 TFLOP/s
per chip from public spec sheets; MFU is *model* FLOPs over peak.
"""

from __future__ import annotations

from typing import Dict, Optional

from horovod_tpu_torch.profiler.flops import FlopsEstimate

# bf16 peak TFLOP/s per chip by device kind (public spec sheets). The H100
# key is the full name CUDA reports for the SXM part: a shorter prefix
# such as "NVIDIA H100" would also give the PCIe (756) and NVL cards the
# SXM peak, since the lookup matches prefixes.
PEAK_TFLOPS_BF16: Dict[str, float] = {
    "TPU v4": 275.0,
    "TPU v5 lite": 197.0,
    "TPU v5": 459.0,
    "TPU v5p": 459.0,
    "TPU v6 lite": 918.0,
    "TPU v6e": 918.0,
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_tflops(device_kind: Optional[str] = None) -> float:
    """bf16 peak TFLOP/s for a device kind (default: CUDA device 0's name,
    ``torch.cuda.get_device_name()``). Returns -1.0 for unknown kinds and
    without CUDA — callers must treat that as "MFU not computable", never
    as a zero peak."""
    if device_kind is None:
        import torch
        if not torch.cuda.is_available():
            return -1.0
        device_kind = torch.cuda.get_device_name(0)
    for prefix, peak in PEAK_TFLOPS_BF16.items():
        if device_kind.startswith(prefix):
            return peak
    return -1.0


def mfu(items_per_sec: float, flops_per_item: float,
        peak_tflops_per_chip: float) -> float:
    """Fraction of the chip's peak the model's own FLOPs achieve.

    ``items_per_sec`` is per chip; ``flops_per_item`` is per item (image,
    sequence, ...). Returns -1.0 when any input is unusable."""
    if items_per_sec <= 0 or flops_per_item <= 0 or peak_tflops_per_chip <= 0:
        return -1.0
    return items_per_sec * flops_per_item / (peak_tflops_per_chip * 1e12)


def mfu_report(items_per_sec: float, estimate: FlopsEstimate,
               peak_tflops_per_chip: float, *,
               round_to: int = 4) -> dict:
    """MFU plus its full provenance, ready for a bench JSON ``method``
    field: value, FLOPs source, per-item FLOPs and the peak divided by."""
    value = mfu(items_per_sec, estimate.flops, peak_tflops_per_chip)
    return {
        "mfu": round(value, round_to) if value > 0 else -1.0,
        "flops_per_item": estimate.flops,
        "flops_source": estimate.source,
        "flops_detail": estimate.detail,
        "peak_tflops_bf16": peak_tflops_per_chip,
    }
