"""The port's BertEncoder against the reference's flax BertEncoder, from the
same weights (converted by ``from_flax_bert``) on the same tokens: a tiny
model (vocab 97, 2 layers, hidden 32, 4 heads, MLP 64, T=64) on the flash
route, the dense route (both picked by ``HOROVOD_FLASH_MIN_SEQ``, which both
packages read) and the reference's default ``use_flash=False`` path;
logits and parameter gradients; the BertBase/BertLarge parameter counts;
one data-parallel step against ``dp.make_train_step`` with ``optax.adamw``
at worlds 1 and 2; and the models' random init against flax's
initializers."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.jax.compression import Compression as RefCompression
from horovod_tpu.models.transformer import BertBase as RefBertBase
from horovod_tpu.models.transformer import BertEncoder as RefBert
from horovod_tpu.models.transformer import BertLarge as RefBertLarge
from horovod_tpu.parallel import dp as ref_dp
from horovod_tpu.parallel import mesh as mesh_lib
from horovod_tpu_torch.models import BertBase, BertEncoder, BertLarge
from horovod_tpu_torch.models.convert import from_flax_bert
from horovod_tpu_torch.models.transformer import mlm_loss

import torch_dist_cases as cases
from test_torch_dp import assert_step_matches

CFG = cases.BERT_CFG
T = cases.BERT_T
# fp32 through two blocks: the flash tolerances of the reference's tests
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
# route -> (use_flash, HOROVOD_FLASH_MIN_SEQ)
ROUTES = {"flash": (True, "64"), "dense": (True, "100000"),
          "mha": (False, "64")}


def perturbed(params, seed):
    """The flax tree with every LayerNorm scale and bias and ``lm_bias``
    moved off its init, so that a swapped mapping shows."""
    rng = np.random.RandomState(seed)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in sorted(node.items())}
        node = np.asarray(node)
        if name in ("scale", "bias", "lm_bias"):
            node = node + rng.normal(0, 0.1, node.shape).astype(node.dtype)
        return node
    return walk(params, "")


def tiny_pair(use_flash=True, dtype="float32", seed=0):
    """(reference module, its params as numpy, port module with the same
    weights)."""
    ref = RefBert(dtype=getattr(jnp, dtype), use_flash=use_flash, **CFG)
    params = ref.init(jax.random.key(seed), jnp.zeros((2, T), jnp.int32))
    params = perturbed(jax.tree_util.tree_map(np.asarray, params["params"]),
                       seed)
    port = BertEncoder(dtype=getattr(torch, dtype), use_flash=use_flash,
                       **CFG)
    port.load_state_dict(from_flax_bert(params), strict=True)
    return ref, params, port


def batch(world=1):
    return cases.bert_batch(world)


def ref_loss(ref, params, b):
    logits = ref.apply({"params": params}, jnp.asarray(b["tokens"]))
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(b["labels"])).mean()


@pytest.fixture
def route(request, monkeypatch):
    use_flash, min_seq = ROUTES[request.param]
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", min_seq)
    return use_flash


@pytest.mark.parametrize("route", sorted(ROUTES), indirect=True)
def test_bert_logits_match_reference(route):
    ref, params, port = tiny_pair(use_flash=route)
    toks = batch()["tokens"]
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(torch.tensor(toks)).numpy()
    assert got.shape == (2, T, CFG["vocab"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("route", sorted(ROUTES), indirect=True)
def test_bert_param_gradients_match_reference(route):
    ref, params, port = tiny_pair(use_flash=route)
    b = batch()
    loss_r, grads_r = jax.value_and_grad(
        lambda p: ref_loss(ref, p, b))(params)
    loss, _ = mlm_loss(port, {k: torch.tensor(v) for k, v in b.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_r), **FWD)
    want = from_flax_bert(jax.tree_util.tree_map(np.asarray, grads_r))
    got = dict(port.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(),
                                   err_msg=name, **GRAD)


def test_bert_flash_route_runs_the_kernel_wrappers_non_causal(monkeypatch):
    """From HOROVOD_FLASH_MIN_SEQ up every block's attention goes through
    the three kernel wrappers once per step, without the causal mask."""
    from horovod_tpu_torch.ops import flash_attention as fa
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", "64")
    _, _, port = tiny_pair()
    # wrapper -> position of its causal flag (after q, k, v; dO, lse, corr)
    flag_at = {"flash_fwd": 3, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}
    calls = {name: [] for name in flag_at}
    for name, at in flag_at.items():
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name, _i=at,
                            **kw: (calls[_n].append(a[_i]), _r(*a, **kw))[1])
    loss, _ = mlm_loss(port, {k: torch.tensor(v) for k, v in batch().items()})
    loss.backward()
    assert calls == {name: [False] * CFG["layers"] for name in flag_at}


def test_bert_bf16_smoke():
    """bf16 compute (fp32 params): finite fp32 logits within bf16
    resolution of the reference."""
    ref, params, port = tiny_pair(dtype="bfloat16")
    toks = batch()["tokens"]
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(torch.tensor(toks))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("name", ["base", "large"])
def test_bert_parameter_counts_match_reference(name):
    ref_cls, port_cls = {"base": (RefBertBase, BertBase),
                         "large": (RefBertLarge, BertLarge)}[name]
    shapes = jax.eval_shape(
        lambda: ref_cls().init(jax.random.key(0),
                               jnp.zeros((1, 8), jnp.int32)))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        port = port_cls()
    assert sum(p.numel() for p in port.parameters()) == want


def test_from_flax_bert_maps_both_layer_norms_and_rejects_strays():
    """The embedding LayerNorm is flax's LayerNorm_0, the final one
    LayerNorm_1 (GPT's final one is LayerNorm_0); strays and gaps raise."""
    _, params, port = tiny_pair()
    sd = port.state_dict()
    np.testing.assert_array_equal(sd["ln_embed.weight"].numpy(),
                                  params["LayerNorm_0"]["scale"])
    np.testing.assert_array_equal(sd["ln_f.bias"].numpy(),
                                  params["LayerNorm_1"]["bias"])
    np.testing.assert_array_equal(sd["lm_bias"].numpy(), params["lm_bias"])
    with pytest.raises(KeyError, match="not mapped"):
        from_flax_bert(dict(params, Stray_0={"kernel": np.zeros(3)}))
    missing = dict(params)
    del missing["LayerNorm_1"]
    with pytest.raises(KeyError, match="missing"):
        from_flax_bert(missing)


def ref_bert_step(ref, params, b, world, compression):
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=world),
                               jax.devices()[:world])
    opt = optax.adamw(cases.LR)

    def loss_fn(p, bt, rng):
        logits = ref.apply({"params": p}, bt["tokens"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, bt["labels"]).mean(), {}

    step = ref_dp.make_train_step(
        loss_fn, opt, mesh, donate=False,
        compression=getattr(RefCompression, compression))
    out = step(ref_dp.replicate(params, mesh),
               ref_dp.replicate(opt.init(params), mesh),
               ref_dp.shard_batch({k: jnp.asarray(v, jnp.int32)
                                   for k, v in b.items()}, mesh),
               jax.random.key(0))
    adam = out.opt_state[0]
    res = {"loss": np.asarray(out.loss)}
    for prefix, tree in (("param", out.params), ("mu", adam.mu),
                         ("nu", adam.nu)):
        sd = from_flax_bert(jax.tree_util.tree_map(np.asarray, tree))
        res.update({f"{prefix}/{k}": v.numpy() for k, v in sd.items()})
    return res


@pytest.mark.parametrize("world", [1, 2])
def test_bert_dp_step_matches_reference(world, tmp_path, monkeypatch):
    """One AdamW step with bf16 gradient compression on the flash route:
    world 1 in process, world 2 as two gloo ranks."""
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", "64")
    ref, params, _ = tiny_pair()
    want = ref_bert_step(ref, params, batch(world), world, "bf16")
    state = {k: v.numpy() for k, v in from_flax_bert(params).items()}
    if world == 1:
        hvd.init(device="cpu")
        try:
            outs = [cases.run_bert_dp_step(0, 1, state, "bf16")]
        finally:
            hvd.shutdown()
    else:
        outs = cases.spawn(2, tmp_path, "bert_dp", (state, "bf16"))
    for got in outs:
        assert_step_matches(got, want)


# ---------------------------------------------------------------------------
# the models' random init against flax's initializers


def test_init_draws_match_flax():
    """A 768x3072 Dense kernel and a 50257x768 embedding drawn by the port's
    reset_parameters against flax's default initializers: the same std
    (within 2%), kernels cut at 2 sigma' (sigma' = 768^-1/2 / 0.8796) as
    flax's truncated normal is, embeddings untruncated (values beyond
    3 sigma, as flax's have)."""
    import flax.linen as nn
    from horovod_tpu_torch.models.gpt import GptDecoder
    model = GptDecoder(vocab=50257, layers=1, hidden=768, heads=12,
                       mlp_dim=3072, max_len=8, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    kernel = model.blocks[0].mlp0.weight.detach().numpy()
    embed = model.embed.detach().numpy()
    assert kernel.shape == (3072, 768) and embed.shape == (50257, 768)
    flax_kernel = np.asarray(nn.initializers.lecun_normal()(
        jax.random.key(1), (768, 3072)))
    flax_embed = np.asarray(nn.Embed(50257, 768).init(
        jax.random.key(2), jnp.zeros((1,), jnp.int32))["params"]["embedding"])
    sigma = 768 ** -0.5
    cut = 2 * sigma / 0.87962566103423978
    for got, want in ((kernel, flax_kernel), (embed, flax_embed)):
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.02)
    assert np.abs(kernel).max() <= cut * (1 + 1e-6)
    assert np.abs(flax_kernel).max() <= cut * (1 + 1e-6)
    assert (np.abs(embed) > 3 * sigma).any()
    assert (np.abs(flax_embed) > 3 * sigma).any()
    np.testing.assert_allclose(embed.std(), sigma, rtol=0.02)


def test_init_of_every_model_follows_flax():
    """Every kernel of the ResNet, MNIST, GPT and BERT inits is cut at
    2 sigma' of its fan_in (kh * kw * cin for a convolution); biases and
    lm_bias are zero, LayerNorm scales one."""
    from horovod_tpu_torch.models import GptDecoder, MnistConvNet, ResNet
    from horovod_tpu_torch.models.resnet import BottleneckBlock, Conv
    from horovod_tpu_torch.models.transformer import Dense, LayerNorm
    g = torch.Generator().manual_seed(4)
    models = [ResNet(block_cls=BottleneckBlock, **cases.RESNET_CFG),
              MnistConvNet(), GptDecoder(dtype=torch.float32,
                                         **cases.GPT_CFG),
              BertEncoder(dtype=torch.float32, **CFG)]
    kernels = 0
    for model in models:
        model.reset_parameters(g)
        for mod in model.modules():
            if isinstance(mod, (Conv, Dense, torch.nn.Conv2d)):
                w = mod.weight.detach()
                cut = 2 * w[0].numel() ** -0.5 / 0.87962566103423978
                assert float(w.abs().max()) <= cut * (1 + 1e-6)
                assert float(w.std()) > 0.5 * cut / 2
                kernels += 1
            if isinstance(mod, LayerNorm):
                assert bool((mod.weight == 1).all())
                assert not bool(mod.bias.any())
    assert not bool(models[-1].lm_bias.any())
    assert kernels == 38
