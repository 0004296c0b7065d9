"""Rendezvous-KV keys of the worker side of the elastic protocol.

Counterpart of the typed builders of ``horovod_tpu/common/kv_keys.py``
(:186-233), limited to the families an elastic worker reads or writes. The
driver publishes ``generation``, ``notify``, ``go`` and ``rank_and_size``;
the worker writes ``worker_state``, ``worker_heartbeat``, ``drain``,
``shard_handoff`` and ``reset_request``. The serving plane's three
(:254-264): a serve worker writes ``serve_addr`` and polls ``serve_stop``;
the router reads the driver's ``serve_targets``. The strings must stay the
reference's: the two sides of the protocol meet on them.
"""


def generation() -> str:
    return "generation"


def notify() -> str:
    return "notify"


def go(gen: int) -> str:
    return f"go/g{int(gen)}"


def rank_and_size(gen: int, host, local_rank) -> str:
    return f"rank_and_size/g{int(gen)}/{host}/{local_rank}"


def worker_state(gen: int, host, local_rank) -> str:
    return f"worker_state/g{int(gen)}/{host}/{local_rank}"


def worker_heartbeat(host, slot) -> str:
    return f"worker_heartbeat/{host}/{slot}"


def drain(host, slot) -> str:
    return f"drain/{host}/{slot}"


def shard_handoff(world: int, old_rank: int) -> str:
    return f"shard_handoff/w{int(world)}/{int(old_rank)}"


def reset_request(gen: int) -> str:
    return f"reset_request/g{int(gen)}"


def serve_targets() -> str:
    return "serve_targets"


def serve_addr(host, local_rank) -> str:
    return f"serve_addr/{host}/{local_rank}"


def serve_stop() -> str:
    return "serve_stop"
