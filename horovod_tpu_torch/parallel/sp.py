"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``horovod_tpu/parallel/sp.py``. The sequence dimension
shards over the ``seq`` mesh axis; each rank holds ``[batch, T/n, heads,
head_dim]`` (BTHD) of q, k and v and calls these functions, as the
reference's run under ``jax.shard_map``:

- :func:`ring_attention` — K/V blocks rotate around the ring
  (``collectives.ppermute``); softmax is accumulated online, so no rank
  holds the full [T, T] score matrix.
- :func:`ulysses_attention` — an all-to-all swaps the sharding from
  sequence to heads, exact local attention runs over the full sequence for
  this rank's heads, and a second all-to-all swaps back.

Both are differentiable: the rotations and exchanges are the autograd
Functions of ``parallel/collectives.py``, so every rank must run the
backward. ``use_flash=True`` runs the local attention through the flash
kernels (``ops/flash_attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import collectives


def _merge(o, m, l, o_i, m_i, l_i):
    """Online-softmax merge of a new block's (out, max, sum) into the
    running accumulation (o: [B, H, T, D]; m, l: [B, H, T])."""
    m_new = torch.maximum(m, m_i)
    a = torch.exp(m - m_new)
    b = torch.exp(m_i - m_new)
    return o * a[..., None] + o_i * b[..., None], m_new, l * a + l_i * b


def _block(q, k, v, mask, sm_scale):
    """One q-block x kv-block attention in fp32: unnormalized out [B, Tq,
    H, D], row max and row sum [B, H, Tq]. ``mask``: [Tq, Tk] additive
    (-inf where masked), or None."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if mask is not None:
        s = s + mask
    m = s.amax(-1)
    # guard fully-masked rows (m = -inf): exp(-inf - -inf) would be NaN
    live = torch.isfinite(m)
    m_safe = torch.where(live, m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(live[..., None], p, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def _causal_mask(q_start: int, k_start: int, tq: int, tk: int, device):
    """[Tq, Tk] additive mask of global positions: 0 where the key is not
    after the query, -inf elsewhere."""
    q_pos = q_start + torch.arange(tq, device=device)[:, None]
    k_pos = k_start + torch.arange(tk, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(q_pos >= k_pos, zero, float("-inf"))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis="seq", causal: bool = False,
                   sm_scale: Optional[float] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Exact attention over a sequence sharded across ``axis``.

    Each of the n ring steps attends this rank's query shard to one K/V
    shard, then rotates K/V to the next rank; the online-softmax
    accumulator makes the result exactly softmax(QK^T)V over the full
    sequence. With ``causal=True`` global positions are ``rank * T_local +
    offset``; blocks wholly in the future contribute nothing.

    ``use_flash=True`` runs each block through the flash kernels with the
    global offsets and merges the (o, lse) partials in fp32
    (``merge_attention``). A wholly future block's rows see no key: the
    kernel gives them lse = NEG_INF, the merge weight 0 and a zero
    gradient, so no NaN enters the ring.
    """
    n = collectives.axis_size(axis)
    idx = collectives.axis_rank(axis)
    t_loc = q.shape[1]
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    perm = [(i, (i + 1) % n) for i in range(n)]

    if use_flash:
        def local(src, k_cur, v_cur):
            return fa.flash_attention(
                q, k_cur, v_cur, causal=causal, sm_scale=scale,
                q_offset=float(idx * t_loc), k_offset=float(src * t_loc),
                return_lse=True)

        o, lse = local(idx, k, v)
        # fp32 accumulator across merges: a per-step cast to bf16 would
        # compound rounding n-1 times
        o = o.float()
        k_cur, v_cur = k, v
        for s in range(1, n):
            k_cur = collectives.ppermute(k_cur, perm, axis)
            v_cur = collectives.ppermute(v_cur, perm, axis)
            o_i, lse_i = local((idx - s) % n, k_cur, v_cur)
            o, lse = fa.merge_attention(o, lse, o_i, lse_i)
        return o.to(q.dtype)

    b, _, h, _ = q.shape
    o = torch.zeros((b, h, t_loc, v.shape[-1]), device=q.device)
    m = torch.full((b, h, t_loc), float("-inf"), device=q.device)
    l = torch.zeros_like(m)

    def attend(s, o, m, l, k_cur, v_cur):
        # after s rotations rank idx holds the kv shard of rank idx - s
        src = (idx - s) % n
        mask = None
        if causal:
            mask = _causal_mask(idx * t_loc, src * t_loc, t_loc,
                                k_cur.shape[1], q.device)
        o_i, m_i, l_i = _block(q, k_cur, v_cur, mask, scale)
        return _merge(o, m, l, o_i.transpose(1, 2), m_i, l_i)

    # rotate-then-attend: the local (s=0) block comes first, so no step
    # ends with a discarded rotation
    o, m, l = attend(0, o, m, l, k, v)
    k_cur, v_cur = k, v
    for s in range(1, n):
        k_cur = collectives.ppermute(k_cur, perm, axis)
        v_cur = collectives.ppermute(v_cur, perm, axis)
        o, m, l = attend(s, o, m, l, k_cur, v_cur)
    l = torch.clamp_min(l, 1e-30)  # fully-masked rows (shouldn't occur)
    out = (o / l[..., None]).transpose(1, 2)
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis="seq", causal: bool = False,
                      sm_scale: Optional[float] = None,
                      use_flash: bool = False) -> torch.Tensor:
    """DeepSpeed-Ulysses-style SP: all-to-all from sequence-sharded to
    head-sharded, exact local attention over the full sequence, all-to-all
    back. Heads must divide the axis size. ``use_flash=True`` runs the
    local full-sequence attention through the flash kernels."""
    n = collectives.axis_size(axis)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"heads ({h}) must be divisible by the '{axis}' "
                         f"axis size ({n})")
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5

    def to_heads(x):
        # [B, T/n, H, D] -> gather seq, scatter heads -> [B, T, H/n, D]
        return collectives.alltoall(x, axis, split_axis=2, concat_axis=1)

    def to_seq(x):
        return collectives.alltoall(x, axis, split_axis=1, concat_axis=2)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    if use_flash:
        out = fa.flash_attention(qh, kh, vh, causal=causal, sm_scale=scale)
        return to_seq(out.to(q.dtype))
    t = qh.shape[1]
    mask = _causal_mask(0, 0, t, t, q.device) if causal else None
    o, _, l = _block(qh, kh, vh, mask, scale)
    l = torch.clamp_min(l, 1e-30)
    out = o / l.transpose(1, 2)[..., None]
    return to_seq(out.to(q.dtype))
