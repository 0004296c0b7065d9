"""Decode loop + tensor-parallel inference execution.

Counterpart of ``horovod_tpu/serve/executor.py``. The loop
(:class:`ServingLoop`), the cached-step contract (:class:`CachedStep`) and
the numpy toy models are copied; the two models that compute run as torch
ops on the device: the tensor-parallel LM (:func:`make_tp_lm_step`,
:class:`TpLm`) and the recurrent reference LM of the fast path
(:func:`make_rnn_lm_step`).

The serving loop is a single consumer thread over a
:class:`~horovod_tpu_torch.serve.batcher.ContinuousBatcher`: every
iteration it (1) frees finished slots and admits queued same-bucket
requests into them, (2) runs ONE decode step for the whole in-flight
batch, (3) appends each request's next token and completes any that
reached their budget, EOS, or deadline. Continuous batching falls out of
doing admission at every step boundary rather than per batch.

``step_fn`` is the execution contract::

    step_fn(tokens [B, L] int32, lengths [B] int32) -> next_token [B] int

with ``B`` fixed at ``max_batch`` (inactive rows padded) and ``L`` the
batch's bucket, so each bucket is one shape for the card's GEMMs.

Built-in step functions:

- :func:`make_toy_step` — deterministic numpy-only model for tests and
  subprocess serve workers (no torch work, instant startup);
- :func:`make_tp_lm_step` — a tensor-parallel decoder over the ``model``
  axis whose per-layer row-parallel reduction rides the int8 quantized
  allreduce when ``compression="int8"``
  (:func:`horovod_tpu_torch.parallel.tp.tp_mlp_inference`): the int8 wire
  applied to activations rather than gradients. The reference's step is
  one program over every device (``shard_map``); the port runs one process
  per GPU, so the step is SPMD over the ``model`` group: the group's first
  rank calls it (its inputs are broadcast to the others) and the others
  run ``step_fn.follow()`` until the first calls ``step_fn.stop()``.

Decode on the plain ``step_fn`` path is prefill-style recompute (the full
forward re-runs per token over the padded bucket): shapes stay static and
the executor stays tiny.

**The serving fast path** layers two optimizations on top, both behind
the :class:`CachedStep` contract::

    cached.advance(tokens [B, L] int32, upto [B] int32,
                   state [B, H] f32, state_len [B] int32)
        -> (preds [B, A] int32, states [B, A, H] f32)

which consumes positions ``state_len..upto-1`` per row and returns the
greedy prediction + model-state checkpoint after each consumed position.
With it the loop:

- **pages model state through the block-paged KV cache**
  (:mod:`horovod_tpu_torch.serve.kv_cache`): per-step cost drops from O(L)
  to O(new tokens), prefill resumes from shared-prefix block checkpoints
  (hash hits pay zero prefill), and each request's block table is bound /
  freed at step boundaries;
- **speculative decoding** (``HOROVOD_SERVE_SPEC_DECODE``): a small draft
  model proposes ``HOROVOD_SERVE_SPEC_DRAFT_K`` tokens per row, the
  target verifies all of them in ONE batched ``advance`` call, and the
  longest agreeing prefix plus the target's bonus token is emitted:
  greedy output is token-identical to the non-speculative path by
  construction (pinned by test). The per-step accept counts are a
  ``4*B``-byte payload published through the ``spec_sync`` hook.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.metrics.registry import MetricsRegistry, get_registry
from horovod_tpu_torch.obs.tracing import (DECODE_STEP, DRAFT, PREFILL,
                                           VERIFY, get_tracer, now_us)
from horovod_tpu_torch.serve.batcher import (ContinuousBatcher,
                                            InferenceRequest,
                                            check_token_ids)

StepFn = Callable[[np.ndarray, np.ndarray], np.ndarray]

# Step-latency histogram bounds (seconds): decode steps live in 100us..1s.
STEP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


class ServingLoop:
    """Owns the decode thread; start/stop/drain lifecycle."""

    def __init__(self, step_fn: StepFn, batcher: ContinuousBatcher,
                 eos_token: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 idle_wait: float = 0.02,
                 cached_step: Optional["CachedStep"] = None,
                 draft_step: Optional["CachedStep"] = None,
                 spec_k: Optional[int] = None,
                 spec_sync: Optional[Callable[[np.ndarray],
                                              np.ndarray]] = None):
        self._step_fn = step_fn
        self._batcher = batcher
        self._eos = eos_token
        self._idle_wait = idle_wait
        # serving fast path: incremental decode over paged model state.
        # The block tables live in the batcher's cache, so the fast path
        # requires one (state has to be owned by the pool the admission
        # charge was made against — otherwise expiry could leak it).
        self._cached = cached_step
        if cached_step is not None and batcher.cache is None:
            raise ValueError("cached_step requires a batcher with a "
                             "PagedKVCache (state pages live in its pool)")
        self._draft = draft_step
        if draft_step is not None and cached_step is None:
            raise ValueError("speculative decoding requires cached_step")
        from horovod_tpu_torch.common.env import env_int
        self._spec_k = spec_k if spec_k is not None \
            else env_int("HOROVOD_SERVE_SPEC_DRAFT_K")
        self.spec_sync = spec_sync
        reg = registry if registry is not None else get_registry()
        self._spec_proposed = reg.counter("hvd_serve_spec_proposed_total")
        self._spec_accepted = reg.counter("hvd_serve_spec_accepted_total")
        self._inflight = reg.gauge("hvd_serve_inflight")
        self._steps = reg.counter("hvd_serve_decode_steps_total")
        self._step_seconds = reg.histogram("hvd_serve_step_seconds",
                                           buckets=STEP_BUCKETS)
        self._failures = reg.counter("hvd_serve_step_failures_total")
        # the step failure that ended the loop for good (None while it
        # serves): a HorovodInternalError, after which the step's group is
        # out of step and no later step can run
        self.fatal: Optional[BaseException] = None
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingLoop":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-serve-loop")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the decode thread to end (``stop()``, a finished
        drain, or a fatal step); True when it has."""
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop pulling new work but finish everything already accepted
        (queued AND running) — the membership-change contract: a departing
        worker completes what it admitted instead of dropping it. Returns
        True when fully drained within ``timeout``."""
        self._draining.set()
        return self._idle.wait(timeout)

    # -- the loop ------------------------------------------------------------

    def _run(self):
        running: List[InferenceRequest] = []
        while not self._stop.is_set():
            running = self._batcher.fill(running)
            if not running:
                self._idle.set()
                self._inflight.set(0)
                if self._draining.is_set() and not self._batcher.pending():
                    break
                self._batcher.wait_for_work(self._idle_wait)
                continue
            self._idle.clear()
            self._inflight.set(len(running))
            self._batcher.observe_step(len(running))
            t0 = time.perf_counter()
            w0 = now_us()
            try:
                if self._cached is not None:
                    emitted = self._step_cached(running)
                else:
                    bucket = running[0].bucket
                    batch = self._batcher.max_batch
                    tokens = np.zeros((batch, bucket), np.int32)
                    # padded rows: 1 dummy token
                    lengths = np.ones(batch, np.int32)
                    for i, r in enumerate(running):
                        seq = r.tokens + r.generated
                        tokens[i, :len(seq)] = seq
                        lengths[i] = len(seq)
                    next_ids = np.asarray(self._step_fn(tokens, lengths))
                    emitted = [[int(next_ids[i])]
                               for i in range(len(running))]
                    dur = (time.perf_counter() - t0) * 1e6
                    for r in running:
                        if r.trace is not None:
                            # recompute path: every step re-runs the full
                            # forward, so each traced row gets one
                            # decode_step span per step
                            get_tracer().record(
                                r.trace, DECODE_STEP, "executor", w0, dur,
                                batch=len(running), bucket=bucket)
            except Exception as e:  # noqa: BLE001 — a broken executor must
                # fail the requests it carried, loudly, not hang them
                self._failures.inc()
                for r in running:
                    self._batcher.complete(r, "failed",
                                           f"decode step failed: {e!r}")
                running = []
                if isinstance(e, HorovodInternalError):
                    # the step's group is out of step: no later step can
                    # run, so fail what is queued and stop for good
                    self.fatal = e
                    self._batcher.close(f"serving loop stopped: {e!r}")
                    break
                continue
            self._step_seconds.observe(time.perf_counter() - t0)
            self._steps.inc()
            now = time.monotonic()
            still: List[InferenceRequest] = []
            for i, r in enumerate(running):
                finished = False
                for tok in emitted[i]:
                    r.generated.append(int(tok))
                    if (self._eos is not None and
                            r.generated[-1] == self._eos) or \
                            len(r.generated) >= r.max_new_tokens or \
                            r.length >= r.bucket:
                        self._batcher.complete(r, "ok")
                        finished = True
                        break
                if finished:
                    continue
                if r.deadline <= now:
                    self._batcher.complete(r, "expired",
                                           "deadline passed mid-generation")
                else:
                    still.append(r)
            running = still
        self._inflight.set(0)
        self._idle.set()

    # -- the serving fast path (cached decode + speculative verify) ----------

    def _step_cached(self, running: List[InferenceRequest]):
        """One fast-path step: per-row cost is O(new tokens), not O(L).

        Prefill rows resume from their shared-prefix checkpoint and
        consume their remaining prompt tail in this step; steady rows
        consume exactly one position — or, with a draft model, propose
        ``spec_k`` tokens and have the target verify all of them in ONE
        batched ``advance`` call, emitting the longest agreeing prefix
        plus the target's bonus token (greedy-identical by
        construction). Returns the emitted token list per row."""
        cache = self._batcher.cache
        n = len(running)
        seqs = [r.tokens + r.generated for r in running]
        for i, r in enumerate(running):
            le = r.lease
            if le.state is None:
                if le.prefix_state is not None:
                    # hash hit: resume from the shared block checkpoint
                    # — this is the prefill compute the reuse pays once
                    le.state = np.asarray(le.prefix_state,
                                          np.float32).copy()
                    le.state_len = le.prefix_covered
                else:
                    le.state = self._cached.init_state(1)[0]
                    le.state_len = 0
        # tracing bookkeeping (all of it keyed on traced being non-empty,
        # so the untraced path costs one list comprehension per step): a
        # row whose state does not yet cover its prompt tail is in
        # prefill this step, the rest are steady decode
        traced = [i for i, r in enumerate(running) if r.trace is not None]
        prefill_rows = {i for i, r in enumerate(running)
                        if r.lease.state_len < len(seqs[i]) - 1}
        draft_win = verify_win = None

        # -- draft proposals (k cheap micro-steps) ---------------------------
        k = self._spec_k if self._draft is not None else 0
        ext = [list(s) for s in seqs]
        props: List[List[int]] = [[] for _ in range(n)]
        traj: List[List[np.ndarray]] = [[] for _ in range(n)]
        if k > 0:
            if traced:
                draft_t0 = (now_us(), time.perf_counter())
            steady = {i for i, r in enumerate(running)
                      if r.lease.state_len == len(seqs[i]) - 1}
            for i, r in enumerate(running):
                if r.lease.draft_state is None:
                    r.lease.draft_state = self._draft.init_state(1)[0]
                    r.lease.draft_len = 0
            for _ in range(k):
                width = max(len(e) for e in ext)
                tok = np.zeros((n, width), np.int32)
                for i, e in enumerate(ext):
                    tok[i, :len(e)] = e
                upto = np.array([len(e) for e in ext], np.int64)
                dstate = np.stack([r.lease.draft_state for r in running])
                dlen = np.array([r.lease.draft_len for r in running],
                                np.int64)
                preds, states = self._draft.advance(tok, upto, dstate,
                                                    dlen)
                for i, r in enumerate(running):
                    c = int(upto[i] - dlen[i])
                    if c > 0:
                        r.lease.draft_state = states[i, c - 1].copy()
                        r.lease.draft_len = int(upto[i])
                    if i in steady:
                        traj[i].append(r.lease.draft_state)
                        p = int(preds[i, c - 1])
                        ext[i].append(p)
                        props[i].append(p)

        if k > 0 and traced:
            draft_win = (draft_t0[0],
                         (time.perf_counter() - draft_t0[1]) * 1e6)

        # -- target verify: ONE batched advance over every row ---------------
        width = max(len(e) for e in ext)
        tok = np.zeros((n, width), np.int32)
        for i, e in enumerate(ext):
            tok[i, :len(e)] = e
        upto = np.array([len(e) for e in ext], np.int64)
        tstate = np.stack([r.lease.state for r in running])
        tlen = np.array([r.lease.state_len for r in running], np.int64)
        if traced:
            verify_t0 = (now_us(), time.perf_counter())
        preds, states = self._cached.advance(tok, upto, tstate, tlen)
        if traced:
            verify_win = (verify_t0[0],
                          (time.perf_counter() - verify_t0[1]) * 1e6)

        emitted: List[List[int]] = []
        accepts = np.zeros(n, np.int32)
        for i, r in enumerate(running):
            le = r.lease
            c = int(upto[i] - tlen[i])
            npp = len(props[i])
            base = c - npp - 1  # pred index right after the last REAL token
            a = 0
            while a < npp and props[i][a] == int(preds[i, base + a]):
                a += 1
            accepts[i] = a
            emitted.append(props[i][:a] + [int(preds[i, base + a])])
            le.state = states[i, base + a].copy()
            prev_len = le.state_len
            le.state_len = int(tlen[i]) + base + a + 1
            if npp and a < npp:
                # reject: roll the draft back to the last accepted
                # checkpoint (traj[j] covers seq + j proposals)
                le.draft_state = traj[i][a].copy() if a < len(traj[i]) \
                    else le.draft_state
                le.draft_len = len(seqs[i]) + a
            # publish the prompt's full-block boundary checkpoints as
            # shared CoW blocks on the prefill step (first crossing of
            # the prompt end)
            prompt_len = len(r.tokens)
            if cache is not None and prev_len < prompt_len:
                bt = cache.block_tokens
                bs = {}
                for end in range(bt, prompt_len + 1, bt):
                    j = end - int(tlen[i]) - 1
                    if prev_len < end and 0 <= j < c:
                        bs[end] = states[i, j]
                if bs:
                    cache.publish(le, r.tokens, bs)
            if cache is not None:
                # the emitted burst may overshoot the budget/bucket (the
                # run loop truncates at append time and completes the
                # request) — never bind past what admission charged for
                covered = min(r.length + len(emitted[i]),
                              len(r.tokens) + r.max_new_tokens, r.bucket)
                cache.bind(le, covered, le.state)
        if k > 0:
            self._spec_proposed.inc(int(sum(len(p) for p in props)))
            self._spec_accepted.inc(int(accepts.sum()))
            if self.spec_sync is not None and any(props):
                # tiny accept/reject exchange: 4*B bytes, deep under the
                # express-lane threshold
                self.spec_sync(accepts)
        if traced:
            tracer = get_tracer()
            for i in traced:
                r = running[i]
                # the target advance IS the prefill compute for rows
                # still consuming their prompt; steady rows decode (and,
                # when speculating, get the draft/verify pair too)
                if i in prefill_rows:
                    tracer.record(r.trace, PREFILL, "executor",
                                  verify_win[0], verify_win[1],
                                  tokens=int(upto[i] - tlen[i]),
                                  resumed_at=int(tlen[i]))
                else:
                    tracer.record(r.trace, DECODE_STEP, "executor",
                                  verify_win[0], verify_win[1], batch=n)
                    if props[i]:
                        tracer.record(r.trace, DRAFT, "executor",
                                      draft_win[0], draft_win[1],
                                      proposed=len(props[i]))
                        tracer.record(r.trace, VERIFY, "executor",
                                      verify_win[0], verify_win[1],
                                      proposed=len(props[i]),
                                      accepted=int(accepts[i]))
        return emitted


# ---------------------------------------------------------------------------
# cached-step contract (the serving fast path's execution interface)


class CachedStep:
    """Incremental greedy decode over an explicit, checkpointable model
    state.

    ``state_dim`` is the per-row state width H. :meth:`advance` consumes
    token positions ``state_len[b]..upto[b]-1`` of row ``b`` and returns,
    for each consumed position, the greedy next-token prediction and the
    state checkpoint *after* consuming it. The state after ``p`` tokens
    is a pure function of those ``p`` tokens — which is exactly what
    makes block-boundary checkpoints shareable across requests
    (hash-based prefix reuse) and eviction loss-free (re-derivable).

    Rows may consume different counts; ``A = max(upto - state_len)`` and
    short rows are right-padded (their padded preds/states are garbage —
    callers index by each row's own consumed count).
    """

    state_dim: int = 1

    def init_state(self, batch: int) -> np.ndarray:
        return np.zeros((batch, self.state_dim), np.float32)

    def advance(self, tokens: np.ndarray, upto: np.ndarray,
                state: np.ndarray, state_len: np.ndarray):
        raise NotImplementedError


class _ToyCachedStep(CachedStep):
    """Cached twin of :func:`make_toy_step`: the model state is the
    running token sum, so ``pred after p tokens = (sum + p) % vocab`` —
    bit-identical to the recompute path, with O(1) per-token cost."""

    state_dim = 1

    def __init__(self, vocab: int = 256):
        self.vocab = vocab

    def advance(self, tokens, upto, state, state_len):
        b, L = tokens.shape
        a = int(max(1, (upto - state_len).max()))
        preds = np.zeros((b, a), np.int32)
        states = np.zeros((b, a, 1), np.float32)
        s = state[:, 0].astype(np.int64).copy()
        pos = state_len.astype(np.int64).copy()
        for j in range(a):
            live = pos < upto
            tok = tokens[np.arange(b), np.minimum(pos, L - 1)]
            s = np.where(live, s + tok, s)
            pos = np.where(live, pos + 1, pos)
            preds[:, j] = (s + pos) % self.vocab
            states[:, j, 0] = s
        return preds, states


def make_toy_cached_step(vocab: int = 256) -> CachedStep:
    return _ToyCachedStep(vocab)


def make_toy_draft_step(vocab: int = 256, wrong_every: int = 0) -> CachedStep:
    """Draft twin of the toy model for speculative-decode tests: agrees
    with the target except (deterministically) every ``wrong_every``-th
    consumed position, so acceptance AND rejection paths both exercise.
    ``wrong_every=0`` is a perfect draft (always accepts)."""
    base = _ToyCachedStep(vocab)
    if not wrong_every:
        return base

    class _Wrong(CachedStep):
        state_dim = 1

        def advance(self, tokens, upto, state, state_len):
            preds, states = base.advance(tokens, upto, state, state_len)
            # perturb predictions at positions where (consumed count)
            # hits the wrong_every stride — a function of state_len so
            # it is deterministic and replayable
            b, a = preds.shape
            for j in range(a):
                at = state_len + j + 1
                bad = (at % wrong_every) == 0
                preds[:, j] = np.where(bad, (preds[:, j] + 1) % vocab,
                                       preds[:, j])
            return preds, states

    return _Wrong()


# ---------------------------------------------------------------------------
# the recurrent reference LM of the fast path, on the device


def _device_guard(device: torch.device):
    """The decode thread's current CUDA device set to ``device`` (a
    serving loop runs the step on its own thread, whose current device is
    otherwise cuda:0)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _RnnCachedStep(CachedStep):
    """Recurrent LM with explicit state: ``h' = tanh(h W + E[tok])``,
    ``logits = h' E^T``, the reference's float operations in its order, as
    torch ops on ``device``.

    :meth:`advance` runs its loop over positions on the device and copies
    the predictions and checkpoints back once per call. Its products run
    on tiles of :attr:`ROWS` rows (the batch zero-padded to a multiple), so
    each row's arithmetic is the same GEMM of the same shape whatever the
    batch holds: the cached, speculative and recompute paths, which call
    it with different batches, give each row the same bits, and their
    greedy tokens are identical (the reference's pin)."""

    ROWS = 8

    def __init__(self, embed: np.ndarray, w: np.ndarray, device):
        from horovod_tpu_torch.models.convert import rnn_lm_params_from_numpy
        self.device = torch.device(device)
        params = rnn_lm_params_from_numpy(embed, w)
        self.embed = params["embed"].to(self.device)
        self.embed_t = self.embed.t().contiguous()
        self.w = params["w"].to(self.device)
        self.state_dim = w.shape[0]

    def _tiled_mm(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.cat([h[i:i + self.ROWS] @ w
                          for i in range(0, h.shape[0], self.ROWS)])

    def advance(self, tokens, upto, state, state_len):
        check_token_ids(tokens, self.embed.shape[0])
        b, L = tokens.shape
        a = int(max(1, (upto - state_len).max()))
        rows = -(-b // self.ROWS) * self.ROWS

        def padded(x, dtype):
            # padded rows have upto == state_len == 0: never live
            out = np.zeros((rows,) + x.shape[1:], dtype)
            out[:b] = x
            return torch.from_numpy(out).to(self.device)

        with torch.no_grad(), _device_guard(self.device):
            tok = padded(tokens, np.int64)
            up = padded(upto, np.int64)
            h = padded(state, np.float32)
            pos = padded(state_len, np.int64)
            preds = torch.empty(rows, a, dtype=torch.int64,
                                device=self.device)
            states = torch.empty(rows, a, self.state_dim,
                                 device=self.device)
            at = torch.arange(rows, device=self.device)
            for j in range(a):
                live = pos < up
                t = tok[at, pos.clamp(max=L - 1)]
                h_new = torch.tanh(self._tiled_mm(h, self.w) + self.embed[t])
                h = torch.where(live[:, None], h_new, h)
                pos = pos + live
                preds[:, j] = self._tiled_mm(h, self.embed_t).argmax(-1)
                states[:, j] = h
            return (preds[:b].to(torch.int32).cpu().numpy(),
                    states[:b].cpu().numpy())


def rnn_lm_weights(hidden: int, vocab: int, seed: int,
                   draft_levels: int):
    """The recurrent LM's numpy weights, drawn as the reference draws them
    (``np.random.RandomState(seed)``: embed, then w), and its draft's:
    both uniformly quantized to ``draft_levels`` levels per tensor in
    numpy, as the reference does. Returns ``(embed, w, draft_embed,
    draft_w)``."""
    rng = np.random.RandomState(seed)
    embed = (rng.randn(vocab, hidden) * 0.5).astype(np.float32)
    w = (rng.randn(hidden, hidden) * (0.9 / np.sqrt(hidden))) \
        .astype(np.float32)

    def quant(x):
        s = np.abs(x).max() / draft_levels
        return (np.round(x / s) * s).astype(np.float32)

    return embed, w, quant(embed), quant(w)


def make_rnn_lm_step(hidden: int = 64, vocab: int = 256, seed: int = 0,
                     draft_levels: int = 24, device=None):
    """Build the fast path's reference LM on ``device`` (default
    ``cuda:local_rank``): ``(step_fn, cached, draft, info)``.

    ``step_fn`` is the classic recompute :data:`StepFn` (derived from the
    same weights by advancing from the zero state every call: the
    recompute baseline). ``cached`` is the incremental
    :class:`CachedStep`. ``draft`` is the weight-quantized target
    (``draft_levels`` uniform levels per tensor): its argmax mostly agrees
    with the target, which is what gives speculation a usable accept rate
    without a trained model."""
    from horovod_tpu_torch.common.basics import resolve_device
    dev = resolve_device(device)
    embed, w, draft_embed, draft_w = rnn_lm_weights(hidden, vocab, seed,
                                                    draft_levels)
    cached = _RnnCachedStep(embed, w, dev)
    draft = _RnnCachedStep(draft_embed, draft_w, dev)

    def step_fn(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        b = tokens.shape[0]
        preds, _ = cached.advance(
            tokens, lengths.astype(np.int64),
            cached.init_state(b), np.zeros(b, np.int64))
        idx = np.maximum(lengths - 1, 0)
        return preds[np.arange(b), np.minimum(idx, preds.shape[1] - 1)] \
            .astype(np.int32)

    info = {"hidden": hidden, "vocab": vocab, "seed": seed,
            "device": str(dev),
            "draft": f"uniform-quantized target ({draft_levels} levels)"}
    return step_fn, cached, draft, info


# ---------------------------------------------------------------------------
# step functions


def make_toy_step(vocab: int = 256) -> StepFn:
    """Deterministic numpy model: next token = (sum of live tokens +
    length) mod vocab. Zero dependencies and microsecond steps: the
    fixture for batcher/router/frontend tests and for subprocess serve
    workers."""

    def step(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        b, L = tokens.shape
        mask = np.arange(L)[None, :] < lengths[:, None]
        s = (tokens * mask).sum(axis=1) + lengths
        return (s % vocab).astype(np.int32)

    return step


def _resolve_compression(compression):
    if compression in (None, "none", ""):
        return None
    if compression == "int8":
        from horovod_tpu_torch.compression import Compression
        return Compression.int8
    return compression  # a Compressor class


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine parameters, eps 1e-6 (the reference's
    ``_ln``)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


class TpLm(torch.nn.Module):
    """The tensor-parallel decoder of :func:`make_tp_lm_step`, one rank's
    shard: embedding -> ``layers`` x [LayerNorm -> TP MLP (column/row
    parallel over ``axis``, tanh between) -> residual] -> LayerNorm -> tied
    head. ``w_in.<i>`` is this rank's ``[hidden, mlp_dim / world]`` and
    ``w_out.<i>`` its ``[mlp_dim / world, hidden]``, as ``P(None,
    "model")`` and ``P("model", None)`` slice them; the row-parallel
    reduction rides the wire ``compression`` picks (None: the fp32 sum).
    ``axis=None`` runs the whole model on one device without a group
    (``tp.row_parallel_inference`` over a world of one: no sum, and the
    int8 wire's two codec round trips).

    :meth:`forward` returns the logits at each row's last live position,
    [B, vocab]. The reference computes the head at every position and then
    takes that one; every position here is computed on its own (the model
    has no attention), so gathering it before the head gives the same
    numbers without the [B, L, vocab] logits."""

    def __init__(self, vocab: int, hidden: int, mlp_dim: int, layers: int,
                 world: int = 1, axis="model", compression=None):
        super().__init__()
        if mlp_dim % world:
            raise ValueError(f"mlp_dim {mlp_dim} does not split over "
                             f"{world} ranks")
        if axis is None and world != 1:
            raise ValueError("axis=None is the whole model on one device")
        per = mlp_dim // world
        self.embed = torch.nn.Parameter(torch.zeros(vocab, hidden))
        self.w_in = torch.nn.ParameterList(
            torch.nn.Parameter(torch.zeros(hidden, per))
            for _ in range(layers))
        self.w_out = torch.nn.ParameterList(
            torch.nn.Parameter(torch.zeros(per, hidden))
            for _ in range(layers))
        self.axis = axis
        self.compression = compression

    def _mlp(self, x, w_in, w_out):
        from horovod_tpu_torch.parallel import tp
        return tp.tp_mlp_inference(x, w_in, w_out, activation=torch.tanh,
                                   axis=self.axis,
                                   compression=self.compression)

    def forward(self, tokens: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.long()]  # [B, L, d]
        for w_in, w_out in zip(self.w_in, self.w_out):
            x = x + self._mlp(_ln(x), w_in, w_out)
        idx = (lengths.long() - 1).clamp(0, tokens.shape[1] - 1)
        last = x[torch.arange(x.shape[0], device=x.device), idx]  # [B, d]
        return _ln(last) @ self.embed.t()


def tp_lm_weights(vocab: int, hidden: int, mlp_dim: int, layers: int,
                  seed: int):
    """The TP LM's numpy weights, drawn as the reference draws them
    (``np.random.RandomState(seed)``: embed, then w_in and w_out per
    layer, each ``randn * 0.05`` in float64 cast to fp32): ``(embed,
    ws)``."""
    rng = np.random.RandomState(seed)
    embed = (rng.randn(vocab, hidden) * 0.05).astype(np.float32)
    ws = []
    for _ in range(layers):
        ws.append((rng.randn(hidden, mlp_dim) * 0.05).astype(np.float32))
        ws.append((rng.randn(mlp_dim, hidden) * 0.05).astype(np.float32))
    return embed, ws


class TpLmStep:
    """The SPMD greedy-decode step of :func:`make_tp_lm_step` (a
    :data:`StepFn`). Every rank of the ``model`` group must run every
    step on the same inputs, in the same order, or the group's
    collectives hang: the group's first rank (:attr:`leader`) calls the
    step and broadcasts each step's inputs to the others, which run
    :meth:`follow` until the leader calls :meth:`stop`. At a world of 1
    there is nothing to broadcast.

    Token ids outside the vocabulary are refused on the host
    (:class:`~horovod_tpu_torch.serve.batcher.InvalidRequest`) before any
    broadcast. Past that point, at a world above 1, a failure on the
    leader leaves the followers partway through the step's collectives,
    where nothing the leader sends next would line up: the step raises
    :class:`HorovodInternalError` then and for good, and sends nothing
    more, not even :meth:`stop`. The followers' collectives fail in turn
    when the leader's process leaves the group (or at its timeout)."""

    _STOP, _RUN = 0, 1

    def __init__(self, model: TpLm, device: torch.device, axis, world: int,
                 leader: bool):
        self.model = model
        self.device = device
        self.axis = axis
        self.world = world
        self.leader = leader
        self.vocab = model.embed.shape[0]
        self._stopped = False
        self._broken: Optional[BaseException] = None

    def _broadcast(self, x: torch.Tensor) -> torch.Tensor:
        from horovod_tpu_torch.parallel import collectives
        return collectives.broadcast(x, root_rank=0, axis=self.axis)

    def _run(self, tokens: torch.Tensor,
             lengths: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(tokens, lengths)

    def logits(self, tokens: np.ndarray, lengths: np.ndarray
               ) -> torch.Tensor:
        """The last-position logits [B, vocab] on the device (leader)."""
        if not self.leader:
            raise RuntimeError("only the model group's first rank calls "
                               "the step; the others follow()")
        if self._broken is not None:
            raise HorovodInternalError(
                f"the model group is out of step since its first rank's "
                f"step failed: {self._broken!r}")
        if self._stopped:
            raise RuntimeError("the step was stopped")
        check_token_ids(tokens, self.vocab)
        b, length = tokens.shape
        with _device_guard(self.device):
            tok = torch.from_numpy(
                np.ascontiguousarray(tokens, np.int32)).to(self.device)
            lens = torch.from_numpy(
                np.ascontiguousarray(lengths, np.int32)).to(self.device)
            if self.world == 1:
                return self._run(tok, lens)
            try:
                self._broadcast(torch.tensor([self._RUN, b, length],
                                             dtype=torch.int32,
                                             device=self.device))
                self._broadcast(torch.cat([lens, tok.reshape(-1)]))
                return self._run(tok, lens)
            except Exception as e:
                self._broken = e
                raise HorovodInternalError(
                    f"the model group's step failed on its first rank, "
                    f"its followers partway through it: {e!r}") from e

    def __call__(self, tokens: np.ndarray,
                 lengths: np.ndarray) -> np.ndarray:
        return self.logits(tokens, lengths).argmax(dim=-1) \
            .to(torch.int32).cpu().numpy()

    def follow(self) -> int:
        """Run the leader's steps until it stops; returns how many."""
        if self.leader:
            raise RuntimeError("the model group's first rank leads; it "
                               "does not follow")
        steps = 0
        with _device_guard(self.device):
            while True:
                head = self._broadcast(torch.zeros(
                    3, dtype=torch.int32, device=self.device)).tolist()
                if head[0] == self._STOP:
                    return steps
                b, length = head[1], head[2]
                payload = self._broadcast(torch.zeros(
                    b * (length + 1), dtype=torch.int32, device=self.device))
                self._run(payload[b:].reshape(b, length), payload[:b])
                steps += 1

    def stop(self) -> None:
        """End the followers' loop (leader; idempotent; nothing is sent
        once a step has failed at a world above 1)."""
        if self.leader and self.world > 1 and not self._stopped and \
                self._broken is None:
            with _device_guard(self.device):
                self._broadcast(torch.tensor([self._STOP, 0, 0],
                                             dtype=torch.int32,
                                             device=self.device))
        self._stopped = True


def make_tp_lm_step(*, vocab: int = 256, hidden: int = 64,
                    mlp_dim: int = 256, layers: int = 2, seed: int = 0,
                    compression=None, device=None, axis="model"):
    """Build a greedy-decode step over a tensor-parallel decoder.

    Returns ``(step_fn, info)``; ``step_fn`` is a :class:`TpLmStep` over
    the ``axis`` group of the initialized job (``horovod_tpu_torch.init()``
    first, unless ``axis=None``: the whole model on ``device`` without
    collectives, as over an axis of one). The model is embeddings ->
    ``layers`` x [LayerNorm -> TP MLP (column/row parallel over ``axis``)
    -> residual] -> LayerNorm -> tied logits, with the per-layer
    row-parallel reduction in the wire format picked by ``compression`` (``None``/``"none"`` ->
    fp32 sum, ``"int8"`` -> the block-quantized allreduce, or a compressor
    class). Weights are drawn from ``seed`` as the reference draws them,
    so every rank (and the parity tests) build identical shards. Runs on
    ``device`` (default ``cuda:local_rank``).

    ``info`` carries the activation wire-byte accounting
    (:func:`activation_wire_report`)."""
    from horovod_tpu_torch.common.basics import resolve_device
    from horovod_tpu_torch.models.convert import tp_lm_params_from_numpy
    from horovod_tpu_torch.parallel import collectives

    comp = _resolve_compression(compression)
    dev = resolve_device(device)
    if axis is None:
        world, rank = 1, 0
    else:
        world, rank = collectives.axis_size(axis), collectives.axis_rank(axis)
    model = TpLm(vocab, hidden, mlp_dim, layers, world=world, axis=axis,
                 compression=comp)
    embed, ws = tp_lm_weights(vocab, hidden, mlp_dim, layers, seed)
    model.load_state_dict(tp_lm_params_from_numpy(embed, ws, rank, world))
    del embed, ws
    model.to(dev).eval()
    step_fn = TpLmStep(model, dev, axis, world, leader=rank == 0)
    info = {
        "vocab": vocab, "hidden": hidden, "mlp_dim": mlp_dim,
        "layers": layers, "tp_world": world, "device": str(dev),
        "compression": "int8" if comp is not None and
        getattr(comp, "quantized", False) else "none",
        "wire": activation_wire_report(hidden, layers, world),
    }
    return step_fn, info


def activation_wire_report(hidden: int, layers: int, world: int) -> dict:
    """Per-token activation wire bytes of the TP forward (one row-parallel
    reduction of ``hidden`` elements per layer) in fp32 vs int8."""
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.parallel.tp import tp_activation_wire_bytes
    n = hidden * layers
    fp32 = tp_activation_wire_bytes(n, world, None)
    int8 = tp_activation_wire_bytes(n, world, Compression.int8)
    return {
        "world": world,
        "reduced_elems_per_token": n,
        "fp32_bytes_per_token": fp32,
        "int8_bytes_per_token": int8,
        "int8_savings_x": round(fp32 / int8, 2) if int8 else None,
    }
