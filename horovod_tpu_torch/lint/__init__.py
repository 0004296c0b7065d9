"""Static analysis of the port: the collective, env and KV-key contracts.

Counterpart of ``horovod_tpu/lint`` (``hvd-lint``) with its Python rules,
bound to the port's own surface (stdlib ``ast``):

- rank-divergent collectives (HVL001), collective-order divergence
  (HVL002), swallowed aborts (HVL003) over the port's collectives and
  ``torch.distributed``'s;
- env discipline, typo detection and the README env table (HVL004-HVL006)
  against ``common/env.py``'s REGISTRY;
- KV keys through ``common/kv_keys.py`` and driver writes claiming the
  control epoch (HVL007-HVL008);
- the kernel ABI (HVL104): ``ops/csrc``'s ``extern "C"`` entry points
  against ``ops/_build.py``'s ctypes signatures, and the dispatch's
  (dtype, head_dim) cases against ``ops/flash_attention.py``'s.

The reference's HVL101-HVL103 read the engine's C++ (condition variables,
locks, atomics), which the port does not have. Run ``python -m horovod_tpu_torch.lint``;
``tests/test_torch_lint.py`` keeps the port at zero findings.
"""

from horovod_tpu_torch.lint.base import RULES, Finding  # noqa: F401
from horovod_tpu_torch.lint.cli import main, run_lint  # noqa: F401
