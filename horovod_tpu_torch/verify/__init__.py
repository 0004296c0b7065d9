"""Protocol verification of the port: executable specs + bounded model
checking, runtime trace conformance and the shared protocol rules.

Counterpart of ``horovod_tpu/verify`` (``hvd-check``):

- ``specs.py`` — nine small pure-Python state machines (negotiation round
  + fast abort, control-epoch fencing, drain -> handoff -> resize, the
  tuned-parameter push, the autoscaler, the paged KV cache, the tiered
  scrape, the replicated KV, the event journal) and 24 seeded mutants,
  built over the port's own ``common/kv_keys.py``, ``common/env.py`` and
  ``rules.py``, so an edit to the port's election rule or epoch fence is
  checked by the specs that argue about it;
- ``checker.py`` — the breadth-first explicit-state checker that explores
  every interleaving (faults included) and prints shortest
  counterexamples; ``spec.py`` its framework;
- ``conformance.py`` — replays KV write-ahead logs, flight-recorder dumps
  and event journals against the protocol rules;
- ``rules.py`` — the election and fencing rules the replicated KV decides
  by, shared with the specs.

Run ``python -m horovod_tpu_torch.verify [--conformance DIR]``;
``tests/test_torch_verify.py`` keeps every spec clean and every mutant
caught.
"""

from horovod_tpu_torch.verify.checker import CheckResult, Violation, check
from horovod_tpu_torch.verify.spec import Invariant, Spec
from horovod_tpu_torch.verify.specs import MUTANTS, SPECS, make_spec

__all__ = [
    "CheckResult", "Violation", "check", "Invariant", "Spec",
    "SPECS", "MUTANTS", "make_spec",
]
