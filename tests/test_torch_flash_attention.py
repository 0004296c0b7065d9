"""The port's flash attention (plain versions of its CUDA kernels, on the CPU)
against the reference's Pallas kernels in interpret mode, on the same numpy
inputs. Mirrors tests/test_flash_attention.py case by case; tolerances are
the reference's own (fp32 forward rtol 2e-4 / atol 2e-5, gradients rtol
2e-3 / atol 2e-4, lse rtol 1e-4 / atol 1e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from horovod_tpu.ops import flash_attention as ref
from horovod_tpu_torch.ops import flash_attention as fa

B, T, H, D = 2, 256, 4, 64
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
LSE = dict(rtol=1e-4, atol=1e-5)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=requires_grad)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def dense(q, k, v, causal):
    s = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) / np.sqrt(D)
    if causal:
        mask = np.tril(np.ones((T, T), bool))
        s = np.where(mask[None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blocks", [(128, 128), (64, 128), (128, 64)])
def test_flash_matches_reference_and_dense(causal, blocks):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             block_q=blocks[0], block_k=blocks[1])
    want = ref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               block_q=blocks[0], block_k=blocks[1],
                               interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    np.testing.assert_allclose(_np(got), dense(q, k, v, causal), **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_matches_reference(causal):
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 128, 2, 32).astype(np.float32) for _ in range(3))
    dout = rng.randn(2, 128, 2, 32).astype(np.float32)

    def loss_ref(q, k, v):
        return jnp.sum(ref.flash_attention(q, k, v, causal=causal,
                                           interpret=True, block_q=64,
                                           block_k=64) * dout)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (fa.flash_attention(tq, tk, tv, causal=causal, block_q=64, block_k=64)
     * _t(dout)).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD)


BWD_CASES = {  # name -> (causal, Tq, Tk, q_offset, with a dlse cotangent)
    "causal": (True, 128, 128, None, False),
    "full": (False, 128, 128, None, False),
    "offset_tq_ne_tk_dlse": (True, 128, 256, 128.0, True),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_flash_backward_matches_reference_at_each_head_width(head_dim, case):
    """dq, dk and dv against jax.grad of the reference (interpret mode,
    return_lse) at every head width the CUDA kernels take, 64-row blocks."""
    causal, tq, tk, q_off, with_dlse = BWD_CASES[case]
    rng = np.random.RandomState(head_dim + tq + tk)
    q, dout = (rng.randn(2, tq, 2, head_dim).astype(np.float32)
               for _ in range(2))
    k, v = (rng.randn(2, tk, 2, head_dim).astype(np.float32)
            for _ in range(2))
    dl = rng.randn(2, 2, tq).astype(np.float32) if with_dlse else \
        np.zeros((2, 2, tq), np.float32)
    kw = dict(causal=causal, block_q=64, block_k=64, q_offset=q_off,
              k_offset=None if q_off is None else 0.0, return_lse=True)

    def loss_ref(q, k, v):
        o, lse = ref.flash_attention(q, k, v, interpret=True, **kw)
        return jnp.sum(o * dout) + jnp.sum(lse * dl)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [_t(x, True) for x in (q, k, v)]
    o, lse = fa.flash_attention(*ts, **kw)
    ((o * _t(dout)).sum() + (lse * _t(dl)).sum()).backward()
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), err_msg=name,
                                   **GRAD)


def test_flash_backward_matches_dense_autograd():
    """The backward kernels' plain versions against autograd through the
    port's own dense path."""
    rng = np.random.RandomState(2)
    q, k, v, dout = (rng.randn(2, 128, 2, 32).astype(np.float32)
                     for _ in range(4))
    grads = []
    for fn in (lambda *a: fa.flash_attention(*a, causal=True, block_q=64,
                                             block_k=64),
               lambda *a: fa.dense_attention(*a, causal=True)):
        ts = [_t(x, True) for x in (q, k, v)]
        (fn(*ts) * _t(dout)).sum().backward()
        grads.append([t.grad for t in ts])
    for g, w in zip(*grads):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD)


def test_flash_lse_value_and_gradient():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 64, 2, 32).astype(np.float32) for _ in range(3))
    _, lse = fa.flash_attention(_t(q), _t(k), _t(v), return_lse=True)
    _, want = ref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  interpret=True, return_lse=True)
    np.testing.assert_allclose(_np(lse), np.asarray(want), **LSE)

    wl = rng.randn(2, 2, 64).astype(np.float32)
    g_ref = jax.grad(lambda q, k, v: jnp.sum(ref.flash_attention(
        q, k, v, interpret=True, return_lse=True)[1] * wl),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [_t(x, True) for x in (q, k, v)]
    (fa.flash_attention(*ts, return_lse=True)[1] * _t(wl)).sum().backward()
    for t, w in zip(ts, g_ref):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), **GRAD)


def test_flash_global_offsets_shift_causal_mask():
    rng = np.random.RandomState(4)
    k, v = (rng.randn(2, 128, 2, 32).astype(np.float32) for _ in range(2))
    q = rng.randn(2, 64, 2, 32).astype(np.float32)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                             q_offset=64.0, k_offset=0.0)
    want = ref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                               interpret=True, q_offset=64.0, k_offset=0.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)

    # a block entirely in the future: lse = NEG_INF and zero output
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                q_offset=-1000.0, return_lse=True)
    assert np.all(_np(lse) < -1e29)
    np.testing.assert_array_equal(_np(o), 0)


def test_flash_fully_masked_rows_match_reference():
    """Rows with no visible key inside a visited tile (negative q_offset):
    lse = NEG_INF, and o is the reference's tile-dependent value (the mean
    of v over the visited tiles), which the plain version reproduces because
    it honours the block sizes. Their gradients are zero."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(1, 128, 2, 32).astype(np.float32) for _ in range(3))
    kw = dict(causal=True, q_offset=-10.0, block_q=64, block_k=64,
              return_lse=True)
    ts = [_t(x, True) for x in (q, k, v)]
    o, lse = fa.flash_attention(*ts, **kw)
    o_ref, lse_ref = ref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                         interpret=True, **kw)
    np.testing.assert_allclose(_np(o), np.asarray(o_ref), **FWD)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_ref), **LSE)
    assert np.all(_np(lse)[:, :, :10] < -1e29)
    np.testing.assert_allclose(_np(o)[0, :10], np.broadcast_to(
        v[0, :64].mean(0), (10, 2, 32)), **FWD)
    o.sum().backward()
    np.testing.assert_array_equal(_np(ts[0].grad)[0, :10], 0)


def test_merge_attention_combines_disjoint_key_sets():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 32, 2, 16).astype(np.float32)
    k, v = (rng.randn(2, 128, 2, 16).astype(np.float32) for _ in range(2))
    o1, l1 = fa.flash_attention(_t(q), _t(k[:, :64]), _t(v[:, :64]),
                                return_lse=True)
    o2, l2 = fa.flash_attention(_t(q), _t(k[:, 64:]), _t(v[:, 64:]),
                                return_lse=True)
    got, lse = fa.merge_attention(o1, l1, o2, l2)
    r1 = ref.flash_attention(*map(jnp.asarray, (q, k[:, :64], v[:, :64])),
                             interpret=True, return_lse=True)
    r2 = ref.flash_attention(*map(jnp.asarray, (q, k[:, 64:], v[:, 64:])),
                             interpret=True, return_lse=True)
    want, want_lse = ref.merge_attention(*r1, *r2)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse), **LSE)
    full = fa.dense_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(_np(got), _np(full), **FWD)


def test_flash_bf16_runs():
    rng = np.random.RandomState(1)
    q32 = rng.randn(1, 256, 2, 64).astype(np.float32)
    q = torch.tensor(q32).to(torch.bfloat16)
    out = fa.flash_attention(q, q, q, causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    # same bf16 inputs through the reference: both round p to bf16 before
    # p . v, so they agree to bf16 resolution
    qj = jnp.asarray(q32, jnp.bfloat16)
    want = ref.flash_attention(qj, qj, qj, causal=True, interpret=True)
    np.testing.assert_allclose(_np(out), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_flash_rejects_degenerate_block_divisor():
    q = torch.zeros((1, 1021, 2, 32))  # prime
    with pytest.raises(ValueError, match="pad the"):
        fa.flash_attention(q, q, q)
    small = torch.zeros((1, 254, 2, 32))
    assert fa.flash_attention(small, small, small).shape == small.shape


def test_flash_rejects_mask_with_flash_model():
    from horovod_tpu_torch.models.transformer import EncoderBlock

    block = EncoderBlock(hidden=32, heads=4, mlp_dim=64,
                         dtype=torch.float32, use_flash=True)
    x = torch.zeros((1, 16, 32))
    mask = torch.ones((16, 16), dtype=torch.bool).tril()
    with pytest.raises(ValueError, match="mask"):
        block(x, mask=mask)


def test_cuda_wrapper_refuses_other_devices():
    """A wrapper runs its plain version only for CPU tensors; on any other
    device it launches the CUDA kernel or raises, never falls back."""
    q = torch.zeros((1, 64, 2, 32), device="meta")
    for kern in (fa.flash_fwd,):
        with pytest.raises(ValueError, match="not supported"):
            kern(q, q, q, False, 1.0)


def _wrapper_inputs(**shapes):
    """CPU inputs of the three wrappers (B=1, Tq=64, Tk=128, H=2, D=32),
    with any of them replaced by a tensor of the given shape."""
    base = {"q": (1, 64, 2, 32), "k": (1, 128, 2, 32), "v": (1, 128, 2, 32),
            "do": (1, 64, 2, 32), "lse": (1, 2, 64), "corr": (1, 2, 64)}
    base.update(shapes)
    return {key: torch.zeros(shape) for key, shape in base.items()}


@pytest.mark.parametrize("bad", [
    dict(q=(1, 64, 2)), dict(k=(2, 128, 2, 32)), dict(k=(1, 128, 4, 32)),
    dict(k=(1, 128, 2, 64)), dict(v=(1, 96, 2, 32)), dict(v=(2, 128, 2, 32)),
    dict(do=(1, 32, 2, 32)), dict(do=(1, 64, 2, 16)), dict(lse=(1, 2, 32)),
    dict(lse=(1, 64, 2)), dict(corr=(1, 2, 128)), dict(corr=(2, 64))])
def test_wrappers_reject_mismatched_shapes(bad):
    """Every wrapper checks that its inputs agree in shape before it picks
    a path, so a mismatched v, do, lse or corr never reaches a kernel (which
    would index it with q's and k's sizes)."""
    t = _wrapper_inputs(**bad)
    args = (True, 0.125, 0.0, 0.0, 64, 64)
    calls = {"flash_fwd": lambda: fa.flash_fwd(t["q"], t["k"], t["v"], *args),
             "flash_bwd_dq": lambda: fa.flash_bwd_dq(*t.values(), *args),
             "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*t.values(), *args)}
    for name, call in calls.items():
        if name == "flash_fwd" and not {"q", "k", "v"} & set(bad):
            call()  # do, lse and corr are not the forward's inputs
            continue
        with pytest.raises(ValueError, match=f"{name}: .* has shape"):
            call()


def test_wrappers_accept_matching_shapes_with_other_value_dim():
    """The plain versions take v's head dim apart from q's, as the
    reference does, and so does the CUDA check."""
    t = _wrapper_inputs(v=(1, 128, 2, 16), do=(1, 64, 2, 16))
    args = (True, 0.125, 0.0, 0.0, 64, 64)
    o, lse = fa.flash_fwd(t["q"], t["k"], t["v"], *args)
    assert o.shape == (1, 64, 2, 16) and lse.shape == (1, 2, 64)
    dk, dv = fa.flash_bwd_dkv(*t.values(), *args)
    assert dk.shape == (1, 128, 2, 32) and dv.shape == (1, 128, 2, 16)
    assert fa._check_cuda("flash_fwd", t) == fa._KERNEL_DTYPES[torch.float32]
    assert fa._check_cuda("flash_bwd_dkv", t) == \
        fa._KERNEL_DTYPES[torch.float32]


@pytest.mark.parametrize("change, error, match", [
    (dict(dtype=torch.float64), TypeError, "float32, bfloat16 or float16"),
    (dict(head_dim=512), ValueError, "head_dim up to 256"),
    (dict(lse_dtype=torch.float64), TypeError, "lse is"),
    (dict(strided="k"), ValueError, "k must be contiguous"),
])
def test_cuda_check_refuses_what_the_kernels_do_not_take(change, error,
                                                         match):
    """The CUDA-only checks (dtype, head_dim, contiguity), run here on CPU
    tensors: a CUDA tensor that fails them raises before any launch."""
    d = change.get("head_dim", 32)
    t = _wrapper_inputs(q=(1, 64, 2, d), k=(1, 128, 2, d),
                        v=(1, 128, 2, d), do=(1, 64, 2, d))
    dtype = change.get("dtype", torch.float32)
    t = {key: (x.to(change.get("lse_dtype", torch.float32))
               if key in ("lse", "corr") else x.to(dtype))
         for key, x in t.items()}
    if "strided" in change:
        x = t["k"]
        t["k"] = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert t["k"].shape == x.shape and not t["k"].is_contiguous()
    fa._check_shapes("flash_bwd_dq", t)
    with pytest.raises(error, match=match):
        fa._check_cuda("flash_bwd_dq", t)


def test_cuda_check_passes_supported_inputs():
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        t = _wrapper_inputs()
        t = {key: x if key in ("lse", "corr") else x.to(dtype)
             for key, x in t.items()}
        assert fa._check_cuda("flash_bwd_dkv", t) == \
            fa._KERNEL_DTYPES[dtype]


# ---------------------------------------------------------------------------
# Length router


def test_attention_router_short_sequence_takes_dense_path(monkeypatch):
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(1, 128, 2, 32)) for _ in range(3))
    called = {"flash": 0}
    real_flash = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: called.__setitem__(
                            "flash", called["flash"] + 1) or
                        real_flash(*a, **kw))
    monkeypatch.delenv("HOROVOD_FLASH_MIN_SEQ", raising=False)
    out = fa.attention(q, k, v, causal=True)  # 128 < default 256
    assert called["flash"] == 0
    assert torch.equal(out, fa.dense_attention(q, k, v, causal=True))


def test_attention_router_long_sequence_takes_flash_path(monkeypatch):
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(1, 256, 2, 32).astype(np.float32) for _ in range(3))
    called = {"flash": 0}
    real_flash = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: called.__setitem__(
                            "flash", called["flash"] + 1) or
                        real_flash(*a, **kw))
    out = fa.attention(_t(q), _t(k), _t(v), causal=False, min_flash_seq=256)
    assert called["flash"] == 1
    want = ref.xla_attention(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(_np(out), np.asarray(want), **FWD)


def test_attention_router_flash_only_arguments_force_flash(monkeypatch):
    called = {"flash": 0}
    real_flash = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: called.__setitem__(
                            "flash", called["flash"] + 1) or
                        real_flash(*a, **kw))
    q = torch.zeros((1, 64, 2, 32))
    fa.attention(q, q, q, return_lse=True)
    fa.attention(q, q, q, causal=True, q_offset=0.0)
    assert called["flash"] == 2


def test_attention_router_env_override(monkeypatch):
    monkeypatch.delenv("HOROVOD_FLASH_MIN_SEQ", raising=False)
    # the port's default is the crossover measured on the H100 (256); the
    # reference keeps the TPU's 1024
    assert fa.flash_min_seq() == fa.DEFAULT_FLASH_MIN_SEQ == 256
    assert ref.flash_min_seq() == ref.DEFAULT_FLASH_MIN_SEQ
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", "64")
    assert fa.flash_min_seq() == ref.flash_min_seq() == 64


def test_dense_attention_matches_reference_xla_path():
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    for causal in (False, True):
        got = fa.dense_attention(_t(q), _t(k), _t(v), causal=causal)
        want = ref.xla_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
        np.testing.assert_allclose(_np(got), dense(q, k, v, causal), **FWD)
    with pytest.raises(ValueError, match="self-attention"):
        fa.dense_attention(_t(q), _t(k[:, :128]), _t(v[:, :128]), causal=True)


def test_short_seq_model_never_calls_flash(monkeypatch):
    """A decoder at seq 128 with use_flash=True routes to the dense path
    (the counterpart of the reference's BERT seq-128 router test)."""
    from horovod_tpu_torch.models.gpt import GptDecoder

    def boom(*a, **kw):
        raise AssertionError("flash kernel must not run at seq 128")

    monkeypatch.setattr(fa, "flash_attention", boom)
    monkeypatch.delenv("HOROVOD_FLASH_MIN_SEQ", raising=False)
    model = GptDecoder(vocab=100, layers=1, hidden=64, heads=2, mlp_dim=128,
                       max_len=128, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    logits = model(torch.zeros((2, 128), dtype=torch.long))
    assert logits.shape == (2, 128, 100)
