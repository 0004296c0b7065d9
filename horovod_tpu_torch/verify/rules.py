"""Shared protocol rules: each a pure function mirroring one decision
point of the control plane.

Counterpart of ``horovod_tpu/verify/rules.py``, copied: the replicated KV
(``runner/replica_kv.py``) reads its vote-grant and majority rules here,
the eager plane (``common/eager.py``) its express-lane rule, and the
port's model checker (``specs.py``) reads all of them;
``tests/test_torch_replica_kv.py`` holds every rule equal to the
reference's over a grid of epochs, terms and lengths, and
``tests/test_torch_verify.py`` holds the epoch rules to the port's
``KVServer`` and ``observe_epoch`` and the express rule to ``_batches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

# outcomes of admit_epoch
FENCED = "fenced"   # strictly-older claim: 409 / StaleEpochError
ADOPT = "adopt"     # newer claim: server adopts + persists it
OK = "ok"           # equal claim or epoch-less write


def admit_epoch(current: int, claimed: Optional[int]) \
        -> Tuple[str, int]:
    """The KV server's epoch-fencing rule (``KVServer._check_epoch_locked``
    in ``runner/http_kv.py``): ``(outcome, new_server_epoch)``.

    - epoch-less writes (claimed is None) pass untouched;
    - strictly-older claims are fenced;
    - newer claims advance (and persist) the server epoch."""
    if claimed is None:
        return OK, current
    if claimed < current:
        return FENCED, current
    if claimed > current:
        return ADOPT, claimed
    return OK, current


def worker_accepts(floor: int, offered: Optional[int]) \
        -> Tuple[bool, int]:
    """The worker-side fencing floor (``runner/elastic/worker.py
    observe_epoch``): ``(accepted, new_floor)``. ``None`` = unfenced
    legacy record, accepted; at/above the floor accepted and raises it;
    strictly below rejected."""
    if offered is None:
        return True, floor
    if offered < floor:
        return False, floor
    return True, offered


def majority(replicas: int) -> int:
    """Quorum size for a replica set (``runner/replica_kv.py``): a write
    is committed — and an election won — only when this many replicas
    (leader/candidate included) hold it."""
    return replicas // 2 + 1


def vote_grants(voter_epoch: int, voter_last_term: int, voter_len: int,
                cand_epoch: int, cand_last_term: int, cand_len: int,
                heard_from_leader: bool) -> bool:
    """The replica election grant rule (``ReplicaKVServer`` vote
    handler): a voter grants a candidate iff

    - it has NOT heard from a live leader inside the lease window (the
      clock assumption that makes at-most-one-leaseholder hold), and
    - the candidate proposes a strictly newer epoch, and
    - the candidate's WAL is at least as up-to-date as the voter's by
      the Raft ordering: ``(last-record term, length)`` compared
      lexicographically. Bare length is NOT enough — two equal-length
      logs can diverge (a deposed leader's un-acked suffix vs the
      successor's committed suffix), and only the term of the last
      record tells them apart. A majority-acked write is on some voter
      in every quorum, and that voter's (term, length) dominates any
      candidate missing it, so no acked write can be missing from the
      new leader."""
    return (not heard_from_leader) and cand_epoch > voter_epoch \
        and (cand_last_term, cand_len) >= (voter_last_term, voter_len)


def express_eligible(size_bytes: int, threshold: int,
                     grouped: bool = False,
                     data_bearing: bool = True) -> bool:
    """The express-lane partition rule (``Controller::LowLatencyEligible``
    in ``engine/src/controller.cc``): small, ungrouped, data-bearing
    responses peel onto the low-latency lane. Every rank must compute
    this identically or cross-rank exec order desyncs — the invariant
    the cycle spec checks."""
    return data_bearing and not grouped and size_bytes <= threshold
