"""Profiling and performance accounting of the port.

Counterpart of ``horovod_tpu/profiler/__init__.py``, for the three layers
ported so far:

- :mod:`~horovod_tpu_torch.profiler.flops` — per-step FLOPs from
  ``torch.utils.flop_counter.FlopCounterMode`` plus the flash kernels'
  explicit share, with the reference's analytic fallbacks.
- :mod:`~horovod_tpu_torch.profiler.mfu` — the shared MFU calculator and
  its peak table (the H100 SXM included).
- :mod:`~horovod_tpu_torch.profiler.annotate` — ``record_function`` and
  NVTX spans around the collectives and the eager ops' host work.

Import is lazy (PEP 562), as in the reference.
"""

from __future__ import annotations

_SUBMODULE_EXPORTS = {
    # flops
    "FlopsEstimate": "flops",
    "compiled_flops": "flops",
    "train_step_flops": "flops",
    "resnet50_train_flops_per_image": "flops",
    "transformer_train_flops_per_seq": "flops",
    # mfu
    "PEAK_TFLOPS_BF16": "mfu",
    "peak_tflops": "mfu",
    "mfu": "mfu",
    "mfu_report": "mfu",
    # annotate
    "collective_scope": "annotate",
    "host_annotation": "annotate",
}

__all__ = sorted(_SUBMODULE_EXPORTS) + ["annotate", "flops", "mfu"]


def __getattr__(name):
    import importlib
    if name in ("annotate", "flops", "mfu"):
        return importlib.import_module(f"{__name__}.{name}")
    mod = _SUBMODULE_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
