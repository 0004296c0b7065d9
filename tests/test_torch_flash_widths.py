"""The flash kernels' whole envelope: every float dtype (fp32, bf16, fp16),
head widths other than 32/64/128 up to 256, and v's width apart from q's.

The plain versions of the three CUDA kernels (what a CPU tensor runs, and
what ``chip_smoke.py`` holds each kernel against on the card) against the
reference's Pallas kernels in interpret mode (``_flash_fwd`` and
``_flash_bwd``), on the same numpy inputs cast to the same dtype. Then the
wrappers' pad-and-slice (the CUDA branch's route for 16-bit widths the TMA
cannot read in place) around the plain versions, bit for bit against the
unpadded plain versions, and a tiny GPT in fp16 through ``make_train_step``
against the reference's fp16 step.

Tolerances: fp32 the reference tests' own (forward rtol 2e-4 / atol 2e-5,
gradients 2e-3 / 2e-4, lse 1e-4 / 1e-5); bf16 and fp16 those
``chip_smoke.tolerances`` gives bf16 (each element within 2e-2 of itself or
of its row's largest value, 1e-2 normwise; lse atol 2e-3): the two sides
cast p and ds to the input dtype at the same places, but sum in other
orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.ops import flash_attention as ref
from horovod_tpu_torch.ops import flash_attention as fa

import torch_dist_cases as cases

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
B, T, H, BLOCK = 1, 128, 2, 64


def _inputs(seed, d, dv, dtype, tq=T, tk=T):
    """q, k, v, do and dlse from numpy, as (torch, jax) pairs in dtype
    (fp32 for dlse); both sides round the same fp32 values."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, tq, H, d), rng.randn(B, tk, H, d),
              rng.randn(B, tk, H, dv), rng.randn(B, tq, H, dv)]
    tdt, jdt = DTYPES[dtype]
    pairs = [(torch.tensor(a.astype(np.float32)).to(tdt),
              jnp.asarray(a.astype(np.float32)).astype(jdt)) for a in arrays]
    dlse = rng.randn(B, H, tq).astype(np.float32)
    return pairs, dlse


def _close(name, got, want, kind, dtype):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        tol = {"fwd": (2e-4, 2e-5), "grad": (2e-3, 2e-4),
               "lse": (1e-4, 1e-5)}[kind]
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=name)
        return
    if kind == "lse":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3,
                                   err_msg=name)
        return
    err = np.abs(got - want)
    row_max = np.abs(want).max(-1, keepdims=True)
    bad = err > 1e-6 + 2e-2 * row_max + 2e-2 * np.abs(want)
    assert not bad.any(), (name, float(err.max()))
    norm = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert norm <= 1e-2, (name, norm)


def _reference(pairs, dlse, causal, scale, q_off, k_off):
    """The Pallas kernels in interpret mode: (o, lse, dq, dk, dv) and the
    corr = dlse - rowsum(do * o) their backward used."""
    q, k, v, do = (j for _, j in pairs)
    offs = (jnp.full((1,), q_off, jnp.float32),
            jnp.full((1,), k_off, jnp.float32))
    o, lse, res = ref._flash_fwd(q, k, v, *offs, causal, scale, BLOCK,
                                 BLOCK, True)
    dq, dk, dv, _, _ = ref._flash_bwd(causal, scale, BLOCK, BLOCK, True, res,
                                      (do, jnp.asarray(dlse)))
    delta = np.einsum("bthd,bthd->bht", np.asarray(do, np.float32),
                      np.asarray(o, np.float32))
    return o, lse, dq, dk, dv, dlse - delta


def _check_plain_against_reference(seed, d, dv, dtype, causal=True,
                                   q_off=0.0, k_off=0.0, tq=T, tk=T):
    pairs, dlse = _inputs(seed, d, dv, dtype, tq, tk)
    scale = d ** -0.5
    o_r, lse_r, dq_r, dk_r, dv_r, corr = _reference(pairs, dlse, causal,
                                                    scale, q_off, k_off)
    q, k, v, do = (t for t, _ in pairs)
    args = (causal, scale, q_off, k_off, BLOCK, BLOCK)
    o, lse = fa.flash_fwd_plain(q, k, v, *args)
    assert o.shape == (B, tq, H, dv) and o.dtype == q.dtype
    # the backward kernels get the reference's lse and corr
    lse_t = torch.tensor(np.asarray(lse_r))
    corr_t = torch.tensor(corr.astype(np.float32))
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse_t, corr_t, *args)
    dk, dvg = fa.flash_bwd_dkv_plain(q, k, v, do, lse_t, corr_t, *args)
    assert (dq.shape, dk.shape, dvg.shape) == \
        ((B, tq, H, d), (B, tk, H, d), (B, tk, H, dv))
    for name, got, want, kind in (("o", o, o_r, "fwd"),
                                  ("lse", lse, lse_r, "lse"),
                                  ("dq", dq, dq_r, "grad"),
                                  ("dk", dk, dk_r, "grad"),
                                  ("dv", dvg, dv_r, "grad")):
        _close(f"{dtype}/d{d}/dv{dv}/{name}", got, want, kind, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [16, 48, 80, 96, 256])
def test_plain_kernels_match_pallas_at_each_width(d, dtype):
    """o, lse, dq, dk and dv at widths the CUDA kernels run at a wider
    instantiation (16 -> 32, 48 -> 64, 80 and 96 -> 128) or at their own
    (256), causal, with a dlse cotangent."""
    _check_plain_against_reference(d, d, d, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,dv", [(192, 128), (64, 32)])
def test_plain_kernels_match_pallas_with_other_value_width(d, dv, dtype):
    """v's width apart from q's: MLA's 192/128 and 64/32, with offsets
    (q at 64 against keys from 0) and Tq != Tk."""
    _check_plain_against_reference(d + dv, d, dv, dtype, q_off=64.0,
                                   tq=64, tk=128)


PAD_CASES = [  # (d, dv, width the kernels would run at)
    (20, 20, 32), (48, 48, 64), (36, 28, 64), (192, 128, 192), (90, 90, 128)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d,dv,w", PAD_CASES)
def test_pad_and_slice_equals_unpadded_plain_bit_for_bit(d, dv, w, dtype):
    """The wrappers' pad-and-slice around each plain version gives the
    unpadded plain version's outputs bit for bit: zero columns add exact
    zeros to every product, and the padded output columns are dropped."""
    assert fa.kernel_width(d, dv) == w
    pairs, dlse = _inputs(7 * d + dv, d, dv, dtype)
    q, k, v, do = (t for t, _ in pairs)
    args = (True, d ** -0.5, 0.0, 0.0, BLOCK, BLOCK)
    o, lse = fa.flash_fwd_plain(q, k, v, *args)
    o_p, lse_p = fa.padded(fa.flash_fwd_plain, w, (dv, None), q, k, v,
                           *args)
    corr = (torch.tensor(dlse) - (do.float() * o.float()).sum(-1)
            .transpose(1, 2)).contiguous()
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, corr, *args)
    dq_p = fa.padded(fa.flash_bwd_dq_plain, w, (d,), q, k, v, do, lse, corr,
                     *args)
    dk, dvg = fa.flash_bwd_dkv_plain(q, k, v, do, lse, corr, *args)
    dk_p, dv_p = fa.padded(fa.flash_bwd_dkv_plain, w, (d, dv), q, k, v, do,
                           lse, corr, *args)
    for name, got, want in (("o", o_p, o), ("lse", lse_p, lse),
                            ("dq", dq_p, dq), ("dk", dk_p, dk),
                            ("dv", dv_p, dvg)):
        assert got.shape == want.shape and got.is_contiguous(), name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("d,dv,dtype,in_place", [
    (64, 64, torch.float16, True), (96, 96, torch.bfloat16, True),
    (192, 128, torch.bfloat16, True), (20, 20, torch.bfloat16, False),
    (36, 28, torch.float16, False), (20, 20, torch.float32, True),
    (90, 90, torch.float32, True)])
def test_cuda_branch_reads_in_place_where_the_tma_can(d, dv, dtype,
                                                      in_place):
    """16-bit tensors whose rows are a multiple of 16 bytes (d and dv
    multiples of 8) are read in place; others are copied padded; fp32 is
    always read in place."""
    assert fa.reads_in_place(dtype, d, dv) is in_place


@pytest.mark.parametrize("d,dv,w", [(1, 1, 32), (32, 32, 32), (33, 8, 64),
                                    (64, 128, 128), (129, 1, 192),
                                    (200, 256, 256)])
def test_kernel_width_is_the_next_instantiation(d, dv, w):
    assert fa.kernel_width(d, dv) == w
    assert w in fa._KERNEL_HEAD_DIMS


def test_widths_above_256_raise_with_the_limit():
    with pytest.raises(ValueError, match="at most 256"):
        fa.kernel_width(257, 64)
    t = {"q": torch.zeros(1, 64, 2, 64), "k": torch.zeros(1, 64, 2, 64),
         "v": torch.zeros(1, 64, 2, 320)}
    with pytest.raises(ValueError, match="head_dim up to 256"):
        fa._check_cuda("flash_fwd", t)


# ---------------------------------------------------------------------------
# a tiny GPT in fp16 through make_train_step against the reference's step

GPT_T = 128


@pytest.fixture
def _flash_from_64(monkeypatch):
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", "64")


def _ref_fp16_step(params, tokens):
    import optax
    from horovod_tpu.models.gpt import GptDecoder as RefGpt
    from horovod_tpu.parallel import dp as ref_dp
    from horovod_tpu.parallel import mesh as mesh_lib
    model = RefGpt(dtype=jnp.float16, **cases.GPT_CFG)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1), jax.devices()[:1])
    opt = optax.adamw(cases.LR)

    def loss_fn(p, batch, rng):
        logits = model.apply({"params": p}, batch)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], batch[:, 1:]).mean(), {}

    step = ref_dp.make_train_step(loss_fn, opt, mesh, donate=False)
    out = step(ref_dp.replicate(params, mesh),
               ref_dp.replicate(opt.init(params), mesh),
               ref_dp.shard_batch(jnp.asarray(tokens, jnp.int32), mesh),
               jax.random.key(0))
    return out


def test_tiny_gpt_fp16_step_matches_reference(_flash_from_64):
    """One AdamW step of the tiny GPT with fp16 compute (fp32 params) on
    the flash path, from the same weights on the same tokens. fp16 keeps
    11 bits: the loss agrees within rtol 2e-3, each parameter's gradient
    (the first moment over 1 - b1) within 2e-2 normwise, and AdamW's first
    step, lr * g / (|g| + eps), moves no parameter more than 2 lr from the
    reference's. The key bias's gradient is zero in exact arithmetic
    (softmax ignores a per-query constant): both sides give rounding noise
    there, which only the 2 lr bound holds."""
    from horovod_tpu.models.gpt import GptDecoder as RefGpt
    from horovod_tpu_torch.models.convert import from_flax_params
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    init = RefGpt(dtype=jnp.float16, **cases.GPT_CFG).init(
        jax.random.key(0), jnp.zeros((2, GPT_T), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, init["params"])
    tokens = np.random.RandomState(1).randint(
        0, cases.GPT_CFG["vocab"], (2, GPT_T)).astype(np.int64)
    out = _ref_fp16_step(params, tokens)
    adam = out.opt_state[0]
    want_params = from_flax_params(jax.tree_util.tree_map(np.asarray,
                                                          out.params))
    want_mu = from_flax_params(jax.tree_util.tree_map(np.asarray, adam.mu))

    model = GptDecoder(dtype=torch.float16, **cases.GPT_CFG)
    model.load_state_dict(from_flax_params(params), strict=True)
    fa.reset_launch_counts()
    hvd.init(device="cpu")
    try:
        got = cases._adamw_step(model, lm_loss, torch.tensor(tokens), "none")
    finally:
        hvd.shutdown()
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], np.asarray(out.loss), rtol=2e-3)
    assert sorted(want_params) == sorted(k[len("param/"):] for k in got
                                         if k.startswith("param/"))
    for name, w in want_params.items():
        g_got = got[f"mu/{name}"] / 0.1
        g_want = want_mu[name].numpy() / 0.1
        norm = np.linalg.norm(g_got - g_want) / \
            max(np.linalg.norm(g_want), 1e-30)
        assert name.endswith("attn.key.bias") or norm <= 2e-2, (name, norm)
        assert np.all(np.abs(got[f"param/{name}"] - w.numpy())
                      <= 2.01 * cases.LR), name


@pytest.mark.parametrize("example", ["gpt_train", "elastic_train"])
def test_gpt_examples_take_float16(example):
    """The GPT examples' --dtype takes float16, as the reference's models
    take any compute dtype."""
    import importlib
    mod = importlib.import_module(f"horovod_tpu_torch.examples.{example}")
    args = mod.parser().parse_args(["--dtype", "float16"])
    assert mod.DTYPES[args.dtype] is torch.float16
