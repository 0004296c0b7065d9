"""Spec constants read from the port's own sources.

Counterpart of ``horovod_tpu/verify/engine_constants.py`` (the name is
kept so a reader finds it). The protocol specs must not hard-code a
private copy of the contract they check: a changed default would leave
the checker verifying a protocol nobody runs. The reference parses its
constants out of the C++ engine (``engine/src``); the port has no engine,
and its eager plane (``common/eager.py``) reads the same knobs from
``common/env.py``'s REGISTRY, so that is where they come from here.

The reference's parse of the engine's coordination flag word
(``kFlag*``), its C ABI version and its export list has no source in the
port (ROADMAP C26): the port's fast abort is the negotiation round's
exchange failing on every rank (``EagerExecutor._fail_all``), not a flag
bit, and it binds its kernels by ``ops/_build.py``'s signatures, which
``tests/test_torch_build_signatures.py`` holds to the ``extern "C"``
declarations.
"""

from __future__ import annotations

from horovod_tpu_torch.common.env import REGISTRY


def low_latency_threshold_default() -> int:
    """Default express-lane eligibility threshold in bytes (the eager
    plane's ``HOROVOD_LOW_LATENCY_THRESHOLD``, as the reference engine's
    ``common.h`` default) — the partition boundary the cycle spec's
    express lane uses."""
    return int(REGISTRY["HOROVOD_LOW_LATENCY_THRESHOLD"][0])

