"""The port's ResNet family and MnistConvNet against the reference's flax
modules on the same weights and images: a tiny ResNet (stages [1, 1], 8
filters, 32x32 images, so the second stage's first block is a stride-2
convolution of an even size, where flax's SAME padding is (0, 1)) in train
mode (logits, gradients, updated batch statistics) and eval mode, the bf16
policy, a full-size ResNet-50 through ``from_flax_resnet``, and the MNIST
ConvNet through ``from_flax_mnist``. Weights are random from a seed, with
BatchNorm scales away from flax's zero init so every branch carries
gradient."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax import lax

from horovod_tpu.models import mnist as ref_mnist
from horovod_tpu.models import resnet as ref_resnet
from horovod_tpu_torch.models import mnist, resnet
from horovod_tpu_torch.models.convert import from_flax_mnist, from_flax_resnet

from torch_dist_cases import randomize

FWD = dict(rtol=1e-4, atol=1e-5)   # fp32 forward
GRAD = dict(rtol=2e-3, atol=2e-4)  # fp32 gradients
BLOCKS = ["BottleneckBlock", "ResNetBlock"]


def tiny(block, framework, **kw):
    cfg = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8, **kw)
    if framework == "ref":
        return ref_resnet.ResNet(block_cls=getattr(ref_resnet, block), **cfg)
    return resnet.ResNet(block_cls=getattr(resnet, block), **cfg)


def setup(block, seed=0, batch=2, size=32, **kw):
    ref = tiny(block, "ref", **kw)
    rs = np.random.RandomState(seed + 100)
    x = rs.rand(batch, size, size, 3).astype(np.float32)
    variables = randomize(jax.eval_shape(ref.init, jax.random.key(0),
                                         jnp.asarray(x)), seed)
    port = tiny(block, "port", **kw)
    port.load_state_dict(from_flax_resnet(variables["params"],
                                          variables["batch_stats"]))
    return ref, variables, port, x


def test_same_pads_match_lax():
    for size in (7, 8, 15, 16):
        for k in (1, 3, 7):
            for s in (1, 2):
                want = lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
                assert resnet.same_pads(size, k, s) == tuple(want)
    assert resnet.same_pads(8, 3, 2) == (0, 1)  # the stride-2 trap


@pytest.mark.parametrize("block", BLOCKS)
def test_tiny_resnet_train_step_matches_flax(block):
    """Train-mode logits, the gradients of a loss over them and the
    updated running statistics."""
    ref, variables, port, x = setup(block)
    cot = np.random.RandomState(7).normal(size=(2, 10)).astype(np.float32)

    def loss_fn(params):
        logits, new = ref.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return jnp.sum(logits * cot), (logits, new["batch_stats"])
    (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])

    got = port(torch.tensor(x), train=True)
    (got * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), logits, **FWD)
    want_grads = from_flax_resnet(jax.tree_util.tree_map(np.asarray, grads))
    got_grads = {n: p.grad for n, p in port.named_parameters()}
    assert sorted(want_grads) == sorted(got_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD)
    want_stats = from_flax_resnet(variables["params"],
                                  jax.tree_util.tree_map(np.asarray, stats))
    for name, buf in port.named_buffers():
        # the running var stores the biased variance, as flax does
        np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(),
                                   err_msg=name, **FWD)


@pytest.mark.parametrize("block", BLOCKS)
def test_tiny_resnet_eval_matches_flax(block):
    ref, variables, port, x = setup(block, seed=1)
    want = jax.jit(ref.apply)(variables, jnp.asarray(x))
    before = {n: b.clone() for n, b in port.named_buffers()}
    got = port(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    for name, buf in port.named_buffers():
        assert torch.equal(buf, before[name]), name


def test_bf16_policy_keeps_params_and_statistics_fp32():
    """Mirrors the reference's test_bf16_policy_keeps_bn_statistics_fp32:
    after a train-mode forward with bf16 compute, parameters and running
    statistics are still fp32 and finite, and the logits are fp32."""
    port = tiny("ResNetBlock", "port", dtype=torch.bfloat16,
                param_dtype=torch.float32)
    port.reset_parameters(torch.Generator().manual_seed(0))
    logits = port(torch.ones(2, 32, 32, 3, dtype=torch.bfloat16), train=True)
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    assert {b.dtype for b in port.buffers()} == {torch.float32}
    assert all(bool(torch.isfinite(b).all()) for b in port.buffers())
    assert logits.dtype == torch.float32


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("train", [True, False])
def test_bf16_logits_match_flax(block, train):
    """bf16 compute on both sides: logits within 2e-2 normwise (convs and
    BatchNorm outputs round to bf16 at different points)."""
    ref, variables, port, x = setup(block, seed=2, dtype=jnp.bfloat16)
    port = tiny(block, "port", dtype=torch.bfloat16)
    port.load_state_dict(from_flax_resnet(variables["params"],
                                          variables["batch_stats"]))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(lambda v, b: ref.apply(v, b, train=train,
                                          mutable=["batch_stats"])[0])(
        variables, xb)
    got = port(torch.tensor(x).to(torch.bfloat16), train=train)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    err = np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want)
    assert err < 2e-2, err


def test_stem_padding_and_nchw_layout_match_flax():
    """``pad_stem_to=8`` makes the stem kernel [7, 7, 8, 64]-shaped (8 input
    channels) with the same logits as flax; NCHW input is one transpose."""
    ref, variables, port, x = setup("ResNetBlock", seed=3, pad_stem_to=8)
    assert variables["params"]["conv_init"]["kernel"].shape == (7, 7, 8, 8)
    assert tuple(port.conv_init.weight.shape) == (8, 8, 7, 7)
    want = jax.jit(ref.apply)(variables, jnp.asarray(x))
    got = port(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    nchw = tiny("ResNetBlock", "port", pad_stem_to=8, input_layout="NCHW")
    nchw.load_state_dict(port.state_dict())
    got_nchw = nchw(torch.tensor(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(got_nchw.detach().numpy(),
                               got.detach().numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tiny("ResNetBlock", "port", input_layout="NHCW")
    padded = resnet.pad_channels_to_multiple(torch.ones(1, 2, 2, 3), 8)
    assert tuple(padded.shape) == (1, 2, 2, 8)
    assert float(padded[..., 3:].abs().sum()) == 0.0


def test_resnet50_converts_and_matches_flax():
    """Every key of a full ResNet-50's trees is consumed, the parameter
    count is ImageNet ResNet-50's (tests/test_models.py), and one fp32
    forward at 32x32 matches flax."""
    ref = ref_resnet.ResNet50(num_classes=1000)
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    variables = randomize(jax.eval_shape(ref.init, jax.random.key(0),
                                         jnp.asarray(x)), 5)
    sd = from_flax_resnet(variables["params"], variables["batch_stats"])
    port = resnet.ResNet50(num_classes=1000)
    port.load_state_dict(sd)  # strict: every expected key present
    n = sum(p.numel() for p in port.parameters())
    assert 25.4e6 < n < 25.7e6, n
    want = jax.jit(ref.apply)(variables, jnp.asarray(x))
    got = port(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    extra = dict(variables["params"], stray={"kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="stray"):
        from_flax_resnet(extra, variables["batch_stats"])
    missing = dict(variables["batch_stats"])
    missing.pop("bn_init")
    with pytest.raises(KeyError, match="bn_init"):
        from_flax_resnet(variables["params"], missing)


def test_mnist_eval_matches_flax():
    ref = ref_mnist.MnistConvNet()
    x = np.random.RandomState(6).rand(3, 28, 28, 1).astype(np.float32)
    params = randomize(jax.eval_shape(ref.init, jax.random.key(0),
                                      jnp.asarray(x))["params"], 6)
    assert params["Dense_0"]["kernel"].shape == (320, 50)
    port = mnist.MnistConvNet()
    port.load_state_dict(from_flax_mnist(params))
    want = jax.jit(ref.apply)({"params": params}, jnp.asarray(x))
    got = port(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    labels = np.array([1, 7, 3])
    want_loss = optax.softmax_cross_entropy_with_integer_labels(
        want, labels).mean()
    got_loss = torch.nn.functional.cross_entropy(got, torch.tensor(labels))
    np.testing.assert_allclose(got_loss.item(), want_loss, **FWD)
    with pytest.raises(ValueError, match="generator"):
        port(torch.tensor(x), train=True)
