"""The port's GptDecoder against the reference's flax GptDecoder, from the same
weights (converted by ``from_flax_params``) on the same tokens. A tiny
model (2 layers, hidden 64, 2 heads, vocab 128, T=128) with
``HOROVOD_FLASH_MIN_SEQ=64`` so that every layer takes the flash path (the
plain versions of the CUDA kernels on the CPU, the Pallas kernels in
interpret mode in the reference)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from horovod_tpu.models.gpt import GptDecoder as RefGpt
from horovod_tpu_torch.models.convert import from_flax_params
from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss

CFG = dict(vocab=128, layers=2, hidden=64, heads=2, mlp_dim=256, max_len=128)
T = 128
# fp32 through two blocks: the flash tolerances of the reference's tests
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)


def tiny_pair(dtype="float32", use_flash=True, seed=0):
    """(reference module, its params as numpy, port module with the same
    weights)."""
    ref = RefGpt(dtype=getattr(jnp, dtype), use_flash=use_flash, **CFG)
    tokens = jnp.zeros((2, T), jnp.int32)
    params = ref.init(jax.random.key(seed), tokens)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = GptDecoder(dtype=getattr(torch, dtype), use_flash=use_flash,
                      **CFG)
    port.load_state_dict(from_flax_params(params), strict=True)
    return ref, params, port


def tokens(seed=1, batch=2):
    return np.random.RandomState(seed).randint(0, CFG["vocab"], (batch, T))


@pytest.fixture(autouse=True)
def _flash_from_64(monkeypatch):
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", "64")


def ref_loss(ref, params, toks):
    logits = ref.apply({"params": params}, toks)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1], toks[:, 1:]).mean()


@pytest.mark.parametrize("use_flash", [True, False])
def test_gpt_logits_match_reference(use_flash):
    ref, params, port = tiny_pair(use_flash=use_flash)
    toks = tokens()
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(torch.tensor(toks)).numpy()
    assert got.shape == (2, T, CFG["vocab"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **FWD)


def test_gpt_flash_path_runs_the_kernel_wrappers(monkeypatch):
    """At T >= HOROVOD_FLASH_MIN_SEQ each layer goes through the three kernel
    wrappers once per step (forward, dq, dk/dv)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    _, _, port = tiny_pair()
    fa.reset_launch_counts()
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for name, key in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                      ("flash_bwd_dkv", "dkv")):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **kw))[1])
    loss, _ = lm_loss(port, torch.tensor(tokens()))
    loss.backward()
    assert calls == {"fwd": CFG["layers"], "dq": CFG["layers"],
                     "dkv": CFG["layers"]}
    # CPU tensors take the plain versions: no kernel launch is counted
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0}


def test_gpt_param_gradients_match_reference():
    ref, params, port = tiny_pair()
    toks = tokens()
    loss_r, grads_r = jax.value_and_grad(
        lambda p: ref_loss(ref, p, jnp.asarray(toks)))(params)
    loss, _ = lm_loss(port, torch.tensor(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_r), **FWD)
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, grads_r))
    got = dict(port.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(),
                                   err_msg=name, **GRAD)


def test_gpt_bf16_smoke():
    """bf16 compute (fp32 params): finite logits of the right shape, within
    bf16 resolution of the reference. The two frameworks round at different
    places (bias adds, residual sums), hence the loose tolerance."""
    ref, params, port = tiny_pair(dtype="bfloat16")
    toks = tokens()
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(torch.tensor(toks))
    assert got.dtype == torch.float32 and got.shape == (2, T, CFG["vocab"])
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


def test_from_flax_params_rejects_unmatched_and_missing_keys():
    _, params, _ = tiny_pair()
    extra = dict(params, Stray_0={"kernel": np.zeros(3)})
    with pytest.raises(KeyError, match="not mapped"):
        from_flax_params(extra)
    blk = dict(params["EncoderBlock_0"])
    del blk["Dense_1"]
    with pytest.raises(KeyError, match="missing"):
        from_flax_params(dict(params, EncoderBlock_0=blk))
