"""Flash attention with hand-written CUDA kernels, forward and backward.

Counterpart of ``horovod_tpu/ops/flash_attention.py``: softmax(QK^T)V
computed tile by tile with an online log-sum-exp, so the [T, T] score
matrix never reaches device memory. The three Pallas kernels of the
reference become three CUDA kernels for Hopper (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``):

- ``flash_fwd`` replaces ``_fwd_kernel`` (o and the per-row lse);
- ``flash_bwd_dq`` replaces ``_bwd_dq_kernel``;
- ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel``.

Each wrapper launches its kernel for a CUDA tensor (or raises) and counts
the launch in its ``launches`` attribute; for a CPU tensor it runs the
kernel's plain PyTorch version, which follows the reference tile by tile,
honouring ``block_q``/``block_k`` exactly. The kernels take what the Pallas
kernels take: fp32, bf16 and fp16, q/k of any width d and v of any width
dv, and any batch * heads. Up to 256 they are instantiated at the widths of
``_KERNEL_HEAD_DIMS``; a launch runs at the smallest one >= max(d, dv) and
reads the narrower tensors in place, their missing columns as zeros, which
change neither q.k^T nor the lse. Above 256 a launch runs the wide
instantiation (``_KERNEL_WIDE``): each block owns one chunk of
``WIDE_CHUNK`` columns of its output (:func:`wide_plan`) and streams the
products over d and dv in chunks of as many columns. Only 16-bit widths
that are not a multiple of 8 (rows the TMA cannot address) are copied
into zero-padded tensors first, and the outputs sliced back. The CUDA
kernels use their own tile sizes (64 rows, or 32 in fp32 above width
128, and 32 or 64 streamed rows); the forward kernel also
takes the block arguments, which decide o on causal rows that see no key
(the mean of v over the keys the reference's tiles visit), so the two
agree on every row.

Layout: [batch, seq, heads, head_dim] in and out; lse is [batch, heads,
Tq] fp32. ``q_offset``/``k_offset`` are global positions of element 0 for
the causal mask, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from horovod_tpu_torch.common.env import env_int
from horovod_tpu_torch.profiler.flops import flash_launch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() NaN-free

# Routing crossover of :func:`attention`: key lengths below it take the
# dense path. Measured on an H100 (``chip_smoke.py`` phase crossover, bf16,
# causal, B=8, H=12, D=64, forward plus backward): the flash kernels beat
# dense attention at every swept length, 256 to 2048, so the threshold is
# the shortest length swept. The reference keeps its TPU value, 1024.
DEFAULT_FLASH_MIN_SEQ = 256

# dtype codes and instantiated head widths of the CUDA kernels, and the
# head_dim code of each dtype's wide instantiation (any d and dv above the
# widest): the cases of HVD_FLASH_DISPATCH and HVD_FLASH_WIDE
# (csrc/flash_common.cuh), kept equal by lint HVL104
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_HEAD_DIMS = (32, 64, 128, 192, 256)
_KERNEL_WIDE = 0
WIDE_CHUNK = 256  # columns of one chunk of the wide kernels (WIDE_C)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three kernels (reference tile order)


def _bh_first(x: torch.Tensor) -> torch.Tensor:  # [B,T,H,D] -> [B*H,T,D]
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d)


def _bh_last(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, T, D] -> [B, T, H, D] (contiguous)."""
    return x.reshape(b, h, x.shape[1], x.shape[2]).permute(0, 2, 1, 3) \
        .contiguous()


def _positions(off: float, base: int, n: int, device) -> torch.Tensor:
    """Global positions of a tile, fp32 as in the reference (exact for
    T < 2^24)."""
    return torch.arange(n, dtype=torch.float32, device=device) + \
        torch.tensor(off + base, dtype=torch.float32, device=device)


def _causal_num_k(q_off: float, k_off: float, qi: int, block_q: int,
                  block_k: int, num_k: int) -> int:
    """Count of k blocks a causal q tile can see (reference
    ``_causal_num_k``)."""
    max_q_pos = q_off + (qi + 1) * block_q - 1
    eff = math.floor((max_q_pos - k_off) / block_k) + 1
    return int(min(max(eff, 0), num_k))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of operands in their own dtype, accumulated in fp32 (the
    reference's ``preferred_element_type=float32``)."""
    return torch.matmul(a.float(), b.float())


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float, q_off: float,
                    k_off: float, block_q: int, block_k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: reference ``_fwd_kernel`` over
    the grid (B*H, Tq/block_q), vectorized over B*H."""
    b, tq, h, _ = q.shape
    tk, dv = k.shape[1], v.shape[-1]
    qb, kb, vb = _bh_first(q), _bh_first(k), _bh_first(v)
    bh, dev = qb.shape[0], q.device
    o = torch.empty(bh, tq, dv, dtype=q.dtype, device=dev)
    lse = torch.empty(bh, tq, dtype=torch.float32, device=dev)
    for qi in range(tq // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        qt = qb[:, rows]
        m = torch.full((bh, block_q, 1), NEG_INF, device=dev)
        l = torch.zeros((bh, block_q, 1), device=dev)
        acc = torch.zeros((bh, block_q, dv), device=dev)
        q_pos = _positions(q_off, qi * block_q, block_q, dev)[:, None]
        num_k = tk // block_k
        if causal:
            num_k = _causal_num_k(q_off, k_off, qi, block_q, block_k, num_k)
        for kj in range(num_k):
            cols = slice(kj * block_k, (kj + 1) * block_k)
            kt, vt = kb[:, cols], vb[:, cols]
            s = _mm(qt, kt.transpose(1, 2)) * sm_scale
            if causal:
                k_pos = _positions(k_off, kj * block_k, block_k, dev)[None]
                s = torch.where(q_pos >= k_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _mm(p.to(v.dtype), vt)
            m = m_new
        o[:, rows] = (acc / l.clamp_min(1e-30)).to(q.dtype)
        lse[:, rows] = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                                   NEG_INF)[..., 0]
    return _bh_last(o, b, h), lse.reshape(b, h, tq)


def flash_bwd_dq_plain(q, k, v, do, lse, corr, causal: bool, sm_scale: float,
                       q_off: float, k_off: float, block_q: int,
                       block_k: int) -> torch.Tensor:
    """Plain version of the dq kernel (reference ``_bwd_dq_kernel``).
    ``lse`` and ``corr`` are [B, H, Tq] fp32; ``do`` is in q's dtype."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qb, kb, vb, dob = (_bh_first(x) for x in (q, k, v, do))
    bh, dev = qb.shape[0], q.device
    lse, corr = lse.reshape(bh, tq, 1), corr.reshape(bh, tq, 1)
    dq = torch.empty(bh, tq, d, dtype=q.dtype, device=dev)
    for qi in range(tq // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        qt, dot = qb[:, rows], dob[:, rows]
        lse_t, corr_t = lse[:, rows], corr[:, rows]
        live = lse_t > NEG_INF / 2
        q_pos = _positions(q_off, qi * block_q, block_q, dev)[:, None]
        acc = torch.zeros((bh, block_q, d), device=dev)
        num_k = tk // block_k
        if causal:
            num_k = _causal_num_k(q_off, k_off, qi, block_q, block_k, num_k)
        for kj in range(num_k):
            cols = slice(kj * block_k, (kj + 1) * block_k)
            kt, vt = kb[:, cols], vb[:, cols]
            s = _mm(qt, kt.transpose(1, 2)) * sm_scale
            p = torch.where(live, torch.exp(s - lse_t), 0.0)
            if causal:
                k_pos = _positions(k_off, kj * block_k, block_k, dev)[None]
                p = torch.where(q_pos >= k_pos, p, 0.0)
            dp = _mm(dot, vt.transpose(1, 2))
            ds = (p * (dp + corr_t) * sm_scale).to(k.dtype)
            acc = acc + _mm(ds, kt)
        dq[:, rows] = acc.to(q.dtype)
    return _bh_last(dq, b, h)


def flash_bwd_dkv_plain(q, k, v, do, lse, corr, causal: bool,
                        sm_scale: float, q_off: float, k_off: float,
                        block_q: int, block_k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel (reference ``_bwd_dkv_kernel``)."""
    b, tq, h, d = q.shape
    tk, dv_dim = k.shape[1], v.shape[-1]
    qb, kb, vb, dob = (_bh_first(x) for x in (q, k, v, do))
    bh, dev = qb.shape[0], q.device
    lse, corr = lse.reshape(bh, tq, 1), corr.reshape(bh, tq, 1)
    dk = torch.empty(bh, tk, d, dtype=k.dtype, device=dev)
    dv = torch.empty(bh, tk, dv_dim, dtype=v.dtype, device=dev)
    num_q = tq // block_q
    for kj in range(tk // block_k):
        cols = slice(kj * block_k, (kj + 1) * block_k)
        kt, vt = kb[:, cols], vb[:, cols]
        k_pos = _positions(k_off, kj * block_k, block_k, dev)[None]
        acc_k = torch.zeros((bh, block_k, d), device=dev)
        acc_v = torch.zeros((bh, block_k, dv_dim), device=dev)
        start = 0
        if causal:
            # first q tile whose max q position reaches this k tile's start
            s0 = math.floor((k_off + kj * block_k - q_off) / block_q)
            start = int(min(max(s0, 0), num_q))
        for i in range(start, num_q):
            rows = slice(i * block_q, (i + 1) * block_q)
            qt, dot = qb[:, rows], dob[:, rows]
            lse_t, corr_t = lse[:, rows], corr[:, rows]
            live = lse_t > NEG_INF / 2
            s = _mm(qt, kt.transpose(1, 2)) * sm_scale
            p = torch.where(live, torch.exp(s - lse_t), 0.0)
            if causal:
                q_pos = _positions(q_off, i * block_q, block_q, dev)[:, None]
                p = torch.where(q_pos >= k_pos, p, 0.0)
            acc_v = acc_v + _mm(p.to(do.dtype).transpose(1, 2), dot)
            dp = _mm(dot, vt.transpose(1, 2))
            ds = (p * (dp + corr_t) * sm_scale).to(q.dtype)
            acc_k = acc_k + _mm(ds.transpose(1, 2), qt)
        dk[:, cols] = acc_k.to(k.dtype)
        dv[:, cols] = acc_v.to(v.dtype)
    return _bh_last(dk, b, h), _bh_last(dv, b, h)


# ---------------------------------------------------------------------------
# Kernel wrappers: CUDA kernel for a CUDA tensor, plain version for a CPU one


def _check_shapes(name: str, tensors: dict) -> None:
    """Check that the inputs agree with each other: q [B,Tq,H,D],
    k [B,Tk,H,D], v [B,Tk,H,Dv], do [B,Tq,H,Dv], lse and corr [B,H,Tq].
    The kernels index every buffer with q's and k's sizes, so a mismatch
    would read past the end of one."""
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    if q.dim() != 4:
        raise ValueError(f"{name}: q has shape {tuple(q.shape)}, expected "
                         "[B, Tq, H, D]")
    b, tq, h, d = q.shape
    tk, dv = k.shape[1] if k.dim() == 4 else -1, v.shape[-1]
    want = {"q": (b, tq, h, d), "k": (b, tk, h, d), "v": (b, tk, h, dv),
            "do": (b, tq, h, dv), "lse": (b, h, tq), "corr": (b, h, tq)}
    for key, t in tensors.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {list(want[key])} from q "
                             f"{list(q.shape)} and k {list(k.shape)}")


def _check_cuda(name: str, tensors: dict) -> int:
    """Check what the CUDA kernel supports, after :func:`_check_shapes`
    (every width and batch * heads are taken); returns its dtype code."""
    q = tensors["q"]
    dtype = q.dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: CUDA kernel takes float32, bfloat16 or "
                        f"float16, got {dtype}")
    for key, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, q on "
                             f"{q.device}")
        want = torch.float32 if key in ("lse", "corr") else dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    return _KERNEL_DTYPES[dtype]


def kernel_width(d: int, dv: int) -> int:
    """The instantiation a launch with q/k of width ``d`` and v of width
    ``dv`` runs at: the smallest of ``_KERNEL_HEAD_DIMS`` >= max(d, dv),
    or above the widest ``_KERNEL_WIDE``."""
    for w in _KERNEL_HEAD_DIMS:
        if max(d, dv) <= w:
            return w
    return _KERNEL_WIDE


def wide_plan(kernel: str, d: int, dv: int) -> list:
    """What each block of a wide launch of ``kernel`` writes, by its grid
    z: (output, first column, end column), chunks of ``WIDE_CHUNK``. The
    forward's z runs over o's dv-chunks, dq's over dq's d-chunks and dk/dv's
    over dV's dv-chunks, then dK's d-chunks (``launch_*_wide`` in csrc)."""
    def chunks(out, w):
        return [(out, c, min(c + WIDE_CHUNK, w))
                for c in range(0, w, WIDE_CHUNK)]
    return {"flash_fwd": chunks("o", dv), "flash_bwd_dq": chunks("dq", d),
            "flash_bwd_dkv": chunks("dv", dv) + chunks("dk", d)}[kernel]


def reads_in_place(dtype: torch.dtype, d: int, dv: int) -> bool:
    """Whether the kernels read tensors of widths ``d`` and ``dv`` in
    place: always in fp32 (plain loads); in 16 bits when each row is a
    multiple of 16 bytes, as the TMA's strides must be."""
    return dtype == torch.float32 or (d % 8 == 0 and dv % 8 == 0)


def padded_width(d: int, dv: int) -> int:
    """The width of the zero-padded copy for 16-bit widths the TMA cannot
    read in place: the instantiation's, or for the wide one the next
    multiple of 8 (16-byte rows)."""
    w = kernel_width(d, dv)
    return w if w != _KERNEL_WIDE else -(-max(d, dv) // 8) * 8


def pad_width(x: torch.Tensor, w: int) -> torch.Tensor:
    """``x`` with zero columns appended to width ``w`` (``x`` itself when
    it is that wide)."""
    if x.shape[-1] == w:
        return x
    return torch.nn.functional.pad(x, (0, w - x.shape[-1]))


def padded(fn, w: int, widths, *args):
    """Pad-and-slice: ``fn`` (a kernel's launch, or its plain version) with
    its 4-D tensor arguments (q, k, v, do) zero-padded to width ``w``, and
    each of its outputs sliced back to its entry of ``widths`` (None: left
    as it is, the lse). Exact: zero columns add nothing to q.k^T, do.v^T or
    the lse, and the padded output columns are dropped."""
    out = fn(*(pad_width(a, w) if isinstance(a, torch.Tensor) and
               a.dim() == 4 else a for a in args))
    outs = out if isinstance(out, tuple) else (out,)
    outs = tuple(o if n is None else o[..., :n].contiguous()
                 for o, n in zip(outs, widths))
    return outs if isinstance(out, tuple) else outs[0]


def _launch(symbol: str, name: str, device: torch.device, *args) -> None:
    from horovod_tpu_torch.ops import _build
    fn = _build.function(symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {rc}")


def _reference_tiling(tq: int, tk: int, block_q: int, block_k: int
                      ) -> Tuple[int, int]:
    """The block sizes the forward kernel takes as the reference's tiling:
    they decide o on causal rows with no visible key (the mean of v over
    the keys the reference's q block visits). Blocks that do not tile the
    sequences describe no reference tiling and pass as (0, 0): every key
    up to Tk then counts."""
    if 0 < block_q and 0 < block_k and tq % block_q == 0 and \
            tk % block_k == 0:
        return block_q, block_k
    return 0, 0


def _require_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} are not supported "
                         "(CUDA runs the kernel, the CPU its plain version)")


def _fwd_cuda(q, k, v, causal, sm_scale, q_off, k_off, block_q, block_k):
    """The forward kernel on tensors it reads in place."""
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[-1]
    w = kernel_width(d, dv)
    o = torch.empty((b, tq, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    bq, bk = _reference_tiling(tq, tk, block_q, block_k)
    _launch("hvd_flash_fwd", "flash_fwd", q.device, _KERNEL_DTYPES[q.dtype],
            w, d, dv, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, int(causal), sm_scale, q_off,
            k_off, bq, bk)
    return o, lse


def _dq_cuda(q, k, v, do, lse, corr, causal, sm_scale, q_off, k_off,
             block_q, block_k):
    """The dq kernel on tensors it reads in place."""
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[-1]
    w = kernel_width(d, dv)
    dq = torch.empty_like(q)
    _launch("hvd_flash_bwd_dq", "flash_bwd_dq", q.device,
            _KERNEL_DTYPES[q.dtype], w, d, dv, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), corr.data_ptr(),
            dq.data_ptr(), b, h, tq, tk, int(causal), sm_scale, q_off, k_off)
    return dq


def _dkv_cuda(q, k, v, do, lse, corr, causal, sm_scale, q_off, k_off,
              block_q, block_k):
    """The dk/dv kernel on tensors it reads in place."""
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[-1]
    w = kernel_width(d, dv)
    dk, dvg = torch.empty_like(k), torch.empty_like(v)
    _launch("hvd_flash_bwd_dkv", "flash_bwd_dkv", q.device,
            _KERNEL_DTYPES[q.dtype], w, d, dv, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), corr.data_ptr(),
            dk.data_ptr(), dvg.data_ptr(), b, h, tq, tk, int(causal),
            sm_scale, q_off, k_off)
    return dk, dvg


def _on_card(name, launch, widths, tensors, *args):
    """The CUDA branch of a wrapper: the checks, then the kernel on the
    tensors in place or, for 16-bit widths the TMA cannot read in place,
    on zero-padded copies, its outputs sliced back to ``widths``."""
    _require_cuda(name, tensors["q"])
    _check_cuda(name, tensors)
    q, v = tensors["q"], tensors["v"]
    d, dv = q.shape[-1], v.shape[-1]
    inputs = tuple(tensors.values())
    if reads_in_place(q.dtype, d, dv):
        return launch(*inputs, *args)
    return padded(launch, padded_width(d, dv), widths, *inputs, *args)


def flash_fwd(q, k, v, causal: bool, sm_scale: float, q_off: float = 0.0,
              k_off: float = 0.0, block_q: int = 512, block_k: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o [B,Tq,H,Dv] in q's dtype, lse [B,H,Tq] fp32)."""
    tensors = {"q": q, "k": k, "v": v}
    _check_shapes("flash_fwd", tensors)
    args = (causal, sm_scale, q_off, k_off, block_q, block_k)
    with flash_launch("flash_fwd", q, k, v, causal, q_off, k_off):
        if q.device.type == "cpu":
            return flash_fwd_plain(q, k, v, *args)
        out = _on_card("flash_fwd", _fwd_cuda, (v.shape[-1], None),
                       tensors, *args)
        flash_fwd.launches += 1
        return out


def flash_bwd_dq(q, k, v, do, lse, corr, causal: bool, sm_scale: float,
                 q_off: float = 0.0, k_off: float = 0.0, block_q: int = 512,
                 block_k: int = 512) -> torch.Tensor:
    """dq kernel: dq [B,Tq,H,D] in q's dtype."""
    tensors = {"q": q, "k": k, "v": v, "do": do, "lse": lse, "corr": corr}
    _check_shapes("flash_bwd_dq", tensors)
    args = (causal, sm_scale, q_off, k_off, block_q, block_k)
    with flash_launch("flash_bwd_dq", q, k, v, causal, q_off, k_off):
        if q.device.type == "cpu":
            return flash_bwd_dq_plain(q, k, v, do, lse, corr, *args)
        out = _on_card("flash_bwd_dq", _dq_cuda, (q.shape[-1],), tensors,
                       *args)
        flash_bwd_dq.launches += 1
        return out


def flash_bwd_dkv(q, k, v, do, lse, corr, causal: bool, sm_scale: float,
                  q_off: float = 0.0, k_off: float = 0.0, block_q: int = 512,
                  block_k: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel: (dk [B,Tk,H,D], dv [B,Tk,H,Dv]) in k's/v's dtype."""
    tensors = {"q": q, "k": k, "v": v, "do": do, "lse": lse, "corr": corr}
    _check_shapes("flash_bwd_dkv", tensors)
    args = (causal, sm_scale, q_off, k_off, block_q, block_k)
    with flash_launch("flash_bwd_dkv", q, k, v, causal, q_off, k_off):
        if q.device.type == "cpu":
            return flash_bwd_dkv_plain(q, k, v, do, lse, corr, *args)
        out = _on_card("flash_bwd_dkv", _dkv_cuda,
                       (k.shape[-1], v.shape[-1]), tensors, *args)
        flash_bwd_dkv.launches += 1
        return out


KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for kern in KERNELS:
        kern.launches = 0


def launch_counts() -> dict:
    return {kern.__name__: kern.launches for kern in KERNELS}


def kernel_info(name: str, dtype: torch.dtype, head_dim: int) -> dict:
    """Registers and local-memory (spill) bytes per thread, dynamic shared
    memory per block and resident blocks per SM of one CUDA kernel
    (``name`` as in :data:`KERNELS`) at an instantiated ``head_dim`` (one
    of ``_KERNEL_HEAD_DIMS``, or ``_KERNEL_WIDE``), as the card reports
    them."""
    import ctypes
    from horovod_tpu_torch.ops import _build
    if dtype not in _KERNEL_DTYPES or \
            head_dim not in _KERNEL_HEAD_DIMS + (_KERNEL_WIDE,):
        raise ValueError(f"no CUDA kernel for {dtype}, head_dim {head_dim}")
    info = (ctypes.c_int * 4)()
    code = _KERNEL_DTYPES[dtype]
    if name == "flash_fwd":
        rc = _build.function("hvd_flash_fwd_info")(code, head_dim, info)
    elif name in ("flash_bwd_dq", "flash_bwd_dkv"):
        which = int(name == "flash_bwd_dkv")
        rc = _build.function("hvd_flash_bwd_info")(which, code, head_dim,
                                                   info)
    else:
        raise ValueError(f"unknown kernel {name!r}")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel attributes failed with "
                           f"cudaError_t {rc}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


# ---------------------------------------------------------------------------
# Autograd and the public surface


class _Flash(torch.autograd.Function):
    """(o, lse) with both outputs differentiable: the reference's
    ``jax.custom_vjp`` around the three kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_off, k_off, block_q,
                block_k):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, causal, sm_scale, q_off, k_off, block_q,
                           block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, q_off, k_off, block_q, block_k)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # delta_i = sum_j do_ij o_ij;  ds = p * (dp + dlse - delta) * scale
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B,H,Tq]
        corr = (dlse.float() - delta).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, corr, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, corr, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _pick_block(t: int, preferred: int) -> int:
    b = min(preferred, t)
    while t % b:
        b -= 1  # powers of two hit immediately
    if b < min(128, preferred, t):
        # a degenerate auto-shrunk divisor (prime/odd-factor T) would give a
        # pathologically fine-grained tiling; fail loudly. Explicitly
        # requested small blocks (preferred <= b) stay allowed.
        raise ValueError(
            f"sequence length {t} has no block divisor >= 128; pad the "
            f"sequence (largest divisor found: {b})")
    return b


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512,
                    q_offset=None, k_offset=None, return_lse: bool = False):
    """softmax(QK^T)V without materializing the score matrix.

    q: [B, Tq, H, D]; k/v: [B, Tk, H, D(v)]. Block sizes shrink to divisors
    of the sequence lengths (they steer the plain version; the CUDA kernels
    tile on their own and take them only for o on rows with no visible
    key). ``q_offset``/``k_offset`` are global positions of
    element 0 for causal masking of sequence-sharded blocks.
    ``return_lse=True`` also returns the per-row log-sum-exp [B, H, Tq]
    fp32; both outputs are differentiable.
    """
    d = q.shape[-1]
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    block_q = _pick_block(q.shape[1], block_q)
    block_k = _pick_block(k.shape[1], block_k)
    q_off = 0.0 if q_offset is None else float(q_offset)
    k_off = 0.0 if k_offset is None else float(k_offset)
    o, lse = _Flash.apply(q, k, v, causal, scale, q_off, k_off, block_q,
                          block_k)
    return (o, lse) if return_lse else o


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain dot attention under an optional boolean ``mask``
    (broadcastable to [B, H, Tq, Tk]; False = masked with NEG_INF):
    products of operands in their dtype accumulated in fp32, softmax in
    fp32, p cast to v's dtype, output in q's dtype."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain dot attention, the short-sequence path (reference
    ``xla_attention``), with the same numerics as the flash path."""
    mask = None
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        if tq != tk:
            raise ValueError(
                "dense_attention supports causal only for self-attention "
                f"(Tq == Tk), got {tq} vs {tk}; use flash_attention with "
                "q_offset/k_offset for sharded causal blocks")
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
    return masked_attention(q, k, v, mask, sm_scale)


def flash_min_seq() -> int:
    """The routing crossover (elements of Tk), env-overridable."""
    return env_int("HOROVOD_FLASH_MIN_SEQ", DEFAULT_FLASH_MIN_SEQ)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, sm_scale: Optional[float] = None,
              min_flash_seq: Optional[int] = None, **flash_kwargs):
    """Length-routed attention: dense below the crossover, the flash
    kernels at or above it, keyed on the key length. ``return_lse`` and
    the offsets force the flash path whatever the length: the dense path
    cannot honour them."""
    if flash_kwargs.get("return_lse") or \
            flash_kwargs.get("q_offset") is not None or \
            flash_kwargs.get("k_offset") is not None:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               **flash_kwargs)
    threshold = min_flash_seq if min_flash_seq is not None else \
        flash_min_seq()
    if k.shape[1] < threshold:
        # flash_kwargs can only hold block sizes here, which mean nothing
        # to the dense formulation.
        return dense_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           **flash_kwargs)


def merge_attention(o_a: torch.Tensor, lse_a: torch.Tensor,
                    o_b: torch.Tensor, lse_b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly merge two attention partials (normalized outputs + lse) over
    disjoint key sets. o: [B, T, H, Dv], lse: [B, H, T]."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(m > NEG_INF / 2, m, 0.0)
    wa = torch.exp(lse_a - m_safe)
    wb = torch.exp(lse_b - m_safe)
    denom = torch.clamp_min(wa + wb, 1e-30)
    fa = (wa / denom).transpose(1, 2)[..., None]
    fb = (wb / denom).transpose(1, 2)[..., None]
    o = o_a.float() * fa + o_b.float() * fb
    lse = torch.where(m > NEG_INF / 2, m + torch.log(denom), NEG_INF)
    return o.to(o_a.dtype), lse
