"""Worker side of the port's multi-process tests (gloo on the CPU).

Imported by the test files and, by name, by the processes they spawn with
``torch.multiprocessing``; it imports torch and the port only, never JAX, so
the workers start quickly. Each job writes its results to an ``.npz`` file
that the parent compares with the reference.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

# name -> (op, dtype, prescale, postscale, accumulate_in_fp32)
ALLREDUCE_CASES = {
    "sum_f32": ("Sum", "float32", 1.0, 1.0, True),
    "avg_f32": ("Average", "float32", 1.0, 1.0, True),
    "avg_bf16": ("Average", "bfloat16", 1.0, 1.0, True),
    "avg_bf16_wire": ("Average", "bfloat16", 1.0, 1.0, False),
    "sum_f16_wire": ("Sum", "float16", 1.0, 1.0, False),
    "sum_i32": ("Sum", "int32", 1.0, 1.0, True),
    "avg_i32": ("Average", "int32", 1.0, 1.0, True),
    "min_f32": ("Min", "float32", 1.0, 1.0, True),
    "max_bf16": ("Max", "bfloat16", 1.0, 1.0, True),
    "min_i32": ("Min", "int32", 1.0, 1.0, True),
    "avg_scaled_f32": ("Average", "float32", 0.5, 3.0, True),
    "sum_scaled_bf16": ("Sum", "bfloat16", 0.25, 2.0, True),
    "sum_scaled_i32": ("Sum", "int32", 2.0, 3.0, True),
    "product_f32": ("Product", "float32", 1.0, 1.0, True),
    "product_bf16": ("Product", "bfloat16", 1.0, 1.0, True),
    "product_scaled_i32": ("Product", "int32", 2.0, 3.0, True),
}

GPT_CFG = dict(vocab=128, layers=2, hidden=64, heads=2, mlp_dim=256,
               max_len=128)
LR = 3e-4


def case_input(name: str, world: int) -> np.ndarray:
    """[world, 3, 5] stacked per-rank input of one allreduce case, float32
    (integer-valued for integer cases)."""
    seed = sorted(ALLREDUCE_CASES).index(name)
    rng = np.random.RandomState(seed)
    if ALLREDUCE_CASES[name][1] == "int32":
        return rng.randint(-10, 10, (world, 3, 5)).astype(np.float32)
    return rng.uniform(-2, 2, (world, 3, 5)).astype(np.float32)


def tree_input(world: int) -> dict:
    """Per-rank leaves of the fused-tree case (mixed dtypes)."""
    rng = np.random.RandomState(99)
    return {"a": rng.uniform(-2, 2, (world, 3, 4)).astype(np.float32),
            "b0": rng.uniform(-2, 2, (world, 5)).astype(np.float32),
            "b1": rng.uniform(-2, 2, (world, 2)).astype(np.float32),
            "c": rng.randint(-9, 9, (world, 3)).astype(np.float32)}


TREE_DTYPES = {"a": "float32", "b0": "bfloat16", "b1": "float32",
               "c": "int32"}


def run_collectives(rank: int, world: int) -> dict:
    """Every allreduce case and the fused tree, on this rank's inputs."""
    from horovod_tpu_torch.ops.fusion import fused_apply_tree
    from horovod_tpu_torch.parallel import collectives as c
    out = {}
    for name, (op, dtype, pre, post, acc) in ALLREDUCE_CASES.items():
        x = torch.tensor(case_input(name, world)[rank]).to(
            getattr(torch, dtype))
        y = c.allreduce(x, op=getattr(c, op), prescale_factor=pre,
                        postscale_factor=post, accumulate_in_fp32=acc)
        assert y.dtype == x.dtype
        out[name] = y.float().numpy()
    leaves = {k: torch.tensor(v[rank]).to(getattr(torch, TREE_DTYPES[k]))
              for k, v in tree_input(world).items()}
    tree = {"a": leaves["a"], "b": [leaves["b0"], leaves["b1"]],
            "c": leaves["c"]}
    red = fused_apply_tree(lambda v: c.allreduce(v, op=c.Average), tree)
    for key, val in (("a", red["a"]), ("b0", red["b"][0]),
                     ("b1", red["b"][1]), ("c", red["c"])):
        out[f"tree_{key}"] = val.float().numpy()
    out["broadcast"] = c.broadcast(torch.full((3,), float(rank + 7)),
                                   root_rank=world - 1).numpy()
    from horovod_tpu_torch.parallel import dp
    model = torch.nn.Linear(2, 2)
    with torch.no_grad():
        model.weight.fill_(rank + 1.0)
    dp.replicate(model)  # every rank takes rank 0's weights
    out["replicate"] = model.weight.detach().numpy().copy()
    out["axis"] = np.array([c.axis_rank(), c.axis_size()], np.float32)
    return out


def _adamw_step(model, loss_fn, batch, compression: str) -> dict:
    """One make_train_step step with AdamW (the reference tests' optax
    defaults) on this rank's shard of ``batch``; loss, params and both
    moments."""
    from horovod_tpu_torch import Compression
    from horovod_tpu_torch.parallel import dp
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    step = dp.make_train_step(
        model, loss_fn, opt, device="cpu",
        compression=getattr(Compression, compression))
    out = step(dp.shard_batch(batch))
    res = {"loss": out.loss.numpy()}
    for name, p in model.named_parameters():
        res[f"param/{name}"] = p.detach().numpy()
        res[f"mu/{name}"] = opt.state[p]["exp_avg"].numpy()
        res[f"nu/{name}"] = opt.state[p]["exp_avg_sq"].numpy()
    return res


def run_dp_step(rank: int, world: int, state: dict, tokens: np.ndarray,
                compression: str) -> dict:
    """One make_train_step step of the tiny GPT (fp32, flash path) on this
    rank's shard of ``tokens``; returns loss, params and AdamW moments."""
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    model = GptDecoder(dtype=torch.float32, **GPT_CFG)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return _adamw_step(model, lm_loss, torch.tensor(tokens), compression)


# ---------------------------------------------------------------------------
# the rest of the collectives (tests/test_torch_collectives_more.py)

# name -> (function, dtype, per-rank shape, keyword arguments); "perm" is
# built from the axis size by PERMS
MORE_CASES = {
    "product_f32": ("allreduce", "float32", (8, 4), dict(op="Product")),
    "product_bf16": ("allreduce", "bfloat16", (8, 4), dict(op="Product")),
    "product_i32_scaled": ("allreduce", "int32", (8, 4),
                           dict(op="Product", prescale_factor=2.0,
                                postscale_factor=3.0)),
    "grouped_avg": ("grouped_allreduce", "mixed", (8, 4),
                    dict(op="Average")),
    "grouped_sum_scaled": ("grouped_allreduce", "mixed", (8, 4),
                           dict(op="Sum", prescale_factor=0.5,
                                postscale_factor=4.0)),
    "hier_avg_f32": ("hierarchical_allreduce", "float32", (8, 4),
                     dict(op="Average")),
    "hier_sum_bf16": ("hierarchical_allreduce", "bfloat16", (8, 4),
                      dict(op="Sum")),
    "hier_avg_bf16_wire": ("hierarchical_allreduce", "bfloat16", (8, 4),
                           dict(op="Average", accumulate_in_fp32=False)),
    "hier_avg_i32": ("hierarchical_allreduce", "int32", (8, 4),
                     dict(op="Average")),
    "hier_sum_odd_scaled": ("hierarchical_allreduce", "float32", (3, 5),
                            dict(op="Sum", prescale_factor=0.5,
                                 postscale_factor=3.0)),
    "hier_max_f32": ("hierarchical_allreduce", "float32", (3, 5),
                     dict(op="Max")),
    "hier_product_f32": ("hierarchical_allreduce", "float32", (8, 4),
                         dict(op="Product")),
    "allgather_f32": ("allgather", "float32", (8, 4), {}),
    "allgather_bf16": ("allgather", "bfloat16", (2, 3), {}),
    "allgather_i32": ("allgather", "int32", (8, 4), {}),
    "alltoall_f32": ("alltoall", "float32", (8, 4), {}),
    "alltoall_f32_1_0": ("alltoall", "float32", (8, 4),
                         dict(split_axis=1, concat_axis=0)),
    "alltoall_bf16_0_1": ("alltoall", "bfloat16", (8, 4),
                          dict(split_axis=0, concat_axis=1)),
    "alltoall_i32": ("alltoall", "int32", (8, 4), {}),
    "reducescatter_sum_f32": ("reducescatter", "float32", (8, 4),
                              dict(op="Sum")),
    "reducescatter_avg_bf16": ("reducescatter", "bfloat16", (8, 4),
                               dict(op="Average")),
    "reducescatter_avg_i32": ("reducescatter", "int32", (8, 4),
                              dict(op="Average")),
    "ppermute_ring_f32": ("ppermute", "float32", (8, 4), dict(perm="ring")),
    "ppermute_partial_bf16": ("ppermute", "bfloat16", (8, 4),
                              dict(perm="partial")),
    "ppermute_identity_i32": ("ppermute", "int32", (8, 4),
                              dict(perm="identity")),
    "broadcast_last_f32": ("broadcast", "float32", (3, 4),
                           dict(root_rank="last")),
}
# dtypes and shapes of the grouped cases' three tensors
GROUPED_DTYPES = ("float32", "bfloat16", "float32")
GROUPED_SHAPES = ((8, 4), (5,), (2, 3))
PERMS = {
    "ring": lambda n: [(i, (i + 1) % n) for i in range(n)],
    "partial": lambda n: [(0, n - 1)],  # the others receive zeros
    "identity": lambda n: [(i, i) for i in range(n)],
}
# axes each world runs the axis-taking cases over; the hierarchical cases
# take no axis (data is the outer, fsdp the inner level) and run once,
# under the tag "h"
MORE_AXES = {1: ["data"], 2: ["data"],
             4: ["data", "fsdp", ("data", "fsdp"), ("fsdp", "data")]}


def axis_tag(axis) -> str:
    return "+".join(axis) if isinstance(axis, tuple) else axis


def more_case_axes(name: str, world: int) -> list:
    """(tag, axis) pairs a case runs over at ``world``."""
    if MORE_CASES[name][0] == "hierarchical_allreduce":
        return [("h", None)]
    return [(axis_tag(a), a) for a in MORE_AXES[world]]


def more_case_input(name: str, world: int) -> list:
    """Per-rank inputs of one case: a list of [world, *shape] float32
    arrays (integer-valued for integer dtypes), three for the grouped
    cases."""
    _, dtype, shape, _ = MORE_CASES[name]
    rng = np.random.RandomState(1000 + sorted(MORE_CASES).index(name))
    mixed = dtype == "mixed"
    out = []
    for dt, shp in zip(GROUPED_DTYPES if mixed else (dtype,),
                       GROUPED_SHAPES if mixed else (shape,)):
        shp = (world, *shp)
        if dt == "int32":
            lo = 1 if "product" in name else -9
            out.append(rng.randint(lo, 4 if "product" in name else 9,
                                   shp).astype(np.float32))
        elif "product" in name:
            out.append(rng.uniform(0.5, 1.5, shp).astype(np.float32))
        else:
            out.append(rng.uniform(-2, 2, shp).astype(np.float32))
    return out


def more_case_kwargs(name: str, n: int) -> dict:
    """The case's keyword arguments for an axis of size ``n``, with op
    names, perms and roots resolved to what both frameworks take (op as its
    attribute name on the collectives module)."""
    kw = dict(MORE_CASES[name][3])
    if "perm" in kw:
        kw["perm"] = PERMS[kw["perm"]](n)
    if kw.get("root_rank") == "last":
        kw["root_rank"] = n - 1
    return kw


def run_more_collectives(rank: int, world: int) -> dict:
    """Every case of MORE_CASES over each of its axes, keyed
    ``name|tag|i`` (i: the tensor of a grouped case); also each axis's
    ``(axis_rank, axis_size)`` after a barrier."""
    from horovod_tpu_torch.parallel import collectives as c
    out = {}
    for axis in MORE_AXES[world]:
        c.barrier(axis)
        out[f"axis|{axis_tag(axis)}"] = np.array(
            [c.axis_rank(axis), c.axis_size(axis)], np.float32)
    for name, (fn, dtype, _, _) in MORE_CASES.items():
        dtypes = GROUPED_DTYPES if dtype == "mixed" else (dtype,)
        xs = [torch.tensor(v[rank]).to(_device(), getattr(torch, dt))
              for v, dt in zip(more_case_input(name, world), dtypes)]
        for tag, axis in more_case_axes(name, world):
            kw = more_case_kwargs(name, c.axis_size(axis or "data"))
            if "op" in kw:
                kw["op"] = getattr(c, kw["op"])
            if axis is not None:
                kw["axis"] = axis
            ys = getattr(c, fn)(xs if fn == "grouped_allreduce" else xs[0],
                                **kw)
            for i, (x, y) in enumerate(zip(xs, ys if isinstance(ys, list)
                                           else [ys])):
                assert y.dtype == x.dtype and y.device == x.device, name
                out[f"{name}|{tag}|{i}"] = _np(y.float())
    return out


# ---------------------------------------------------------------------------
# SyncBatchNorm, the stateful and eval steps, dropout per replica
# (tests/test_torch_stateful_dp.py)

RESNET_CFG = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)
SGD_LR = 0.1
BN_MOMENTA = (0.9, 0.5)
BN_FEATURES = 6
DROPOUT_SEED = 1234


def randomize(tree, seed: int) -> dict:
    """A flax variables tree (or its shapes, from ``jax.eval_shape``) with
    seeded random float32 values, leaves filled in sorted key order:
    LeCun-normal kernels, BatchNorm scales and variances in [0.5, 1.5],
    small biases and means."""
    rng = np.random.RandomState(seed)

    def fill(node, name):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: fill(node[k], k) for k in sorted(node)}
        shape = tuple(node.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)
    return fill(tree, "")


def bn_inputs():
    """Global [16, 6] input and cotangent of the SyncBatchNorm case, and
    the scale and bias both frameworks start from."""
    rng = np.random.RandomState(21)
    x = rng.uniform(-2, 2, (16, BN_FEATURES)).astype(np.float32)
    cot = rng.normal(size=(16, BN_FEATURES)).astype(np.float32)
    scale = (1.0 + 0.1 * np.arange(BN_FEATURES)).astype(np.float32)
    bias = (0.05 * np.arange(BN_FEATURES)).astype(np.float32)
    return x, cot, scale, bias


def resnet_batch(world: int) -> dict:
    """The global batch of the stateful step: 2 images per replica."""
    rng = np.random.RandomState(31)
    return {"image": rng.rand(2 * world, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, 2 * world).astype(np.int64)}


def mnist_images() -> np.ndarray:
    return np.random.RandomState(41).rand(2, 28, 28, 1).astype(np.float32)


def _device() -> torch.device:
    """The device this worker's job runs on (``init()``'s)."""
    from horovod_tpu_torch.common import basics
    return basics.device()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _slice(x, rank, world):
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def run_sync_bn(rank: int, world: int) -> dict:
    """SyncBatchNorm on this rank's slice of the global input, train mode:
    output, input and parameter gradients of sum(out * cot), running
    statistics; then eval mode. One run per momentum of BN_MOMENTA."""
    from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm
    x, cot, scale, bias = bn_inputs()
    res = {}
    for m in BN_MOMENTA:
        bn = SyncBatchNorm(BN_FEATURES, momentum=m).to(_device())
        with torch.no_grad():
            bn.scale.copy_(torch.tensor(scale))
            bn.bias.copy_(torch.tensor(bias))
        xs = torch.tensor(_slice(x, rank, world)).to(_device())
        xs.requires_grad_(True)
        y = bn(xs)
        (y * torch.tensor(_slice(cot, rank, world)).to(_device())).sum() \
            .backward()
        res.update({f"{m}/y": _np(y), f"{m}/dx": _np(xs.grad),
                    f"{m}/dscale": _np(bn.scale.grad),
                    f"{m}/dbias": _np(bn.bias.grad),
                    f"{m}/mean": _np(bn.mean), f"{m}/var": _np(bn.var),
                    f"{m}/eval": _np(bn(xs, use_running_average=True))})
    return res


def run_stateful_step(rank: int, world: int, state: dict,
                      hierarchical: bool) -> dict:
    """One make_stateful_train_step step of the tiny ResNet (fp32,
    BottleneckBlock) with SGD + momentum on this rank's shard; loss,
    params, momentum buffers, the synced running statistics and an integer
    aux leaf; then make_eval_step's gathered logits from ``state``."""
    import torch.nn.functional as F
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from horovod_tpu_torch.parallel import dp

    def fresh():
        model = ResNet(block_cls=BottleneckBlock, **RESNET_CFG)
        model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        return model

    def loss_fn(m, b):
        loss = F.cross_entropy(m(b["image"], train=True), b["label"])
        return loss, {"rank_plus_one": torch.tensor(rank + 1,
                                                    dtype=torch.int32)}

    model = fresh()
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR, momentum=0.9)
    step = dp.make_stateful_train_step(model, loss_fn, opt,
                                       device=_device(),
                                       hierarchical=hierarchical)
    batch = dp.shard_batch({k: torch.tensor(v)
                            for k, v in resnet_batch(world).items()})
    out = step(batch)
    res = {"loss": _np(out.loss),
           "rank_plus_one": _np(out.aux["rank_plus_one"])}
    for name, p in model.named_parameters():
        res[f"param/{name}"] = _np(p)
        res[f"momentum/{name}"] = _np(opt.state[p]["momentum_buffer"])
    for name, b in out.model_state.items():
        res[f"stats/{name}"] = _np(b)
    evaluate = dp.make_eval_step(fresh(), lambda m, b: m(b["image"]),
                                 device=_device())
    res["eval_logits"] = _np(evaluate(batch))
    return res


def run_dropout_masks(rank: int, world: int) -> dict:
    """MnistConvNet through make_stateful_train_step with a seed, twice
    from the same weights on the same images on every rank: the dropout
    mask of each run (the integer aux leaf passes through unsynced)."""
    from horovod_tpu_torch.models.mnist import MnistConvNet
    from horovod_tpu_torch.parallel import dp

    def loss_fn(m, images, gen):
        seen = {}
        hooks = [m.dense0.register_forward_hook(
                     lambda mod, args, out: seen.setdefault("pre", out)),
                 m.dense1.register_forward_pre_hook(
                     lambda mod, args: seen.setdefault("post", args[0]))]
        logits = m(images, train=True, generator=gen)
        for hook in hooks:
            hook.remove()
        # 1 kept, 0 dropped, -1 where the ReLU before dropout gave 0
        kept = torch.where(seen["pre"] > 0, (seen["post"] != 0).int(), -1)
        return logits.square().mean(), {"kept": kept.to(torch.int32)}

    res = {}
    for run in range(2):
        model = MnistConvNet()
        model.reset_parameters(torch.Generator().manual_seed(0))
        opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
        step = dp.make_stateful_train_step(model, loss_fn, opt,
                                           device=_device())
        out = step(torch.tensor(mnist_images()), seed=DROPOUT_SEED)
        res[f"mask{run}"] = _np(out.aux["kept"])
    return res


def run_stateful(rank: int, world: int, state: dict,
                 hierarchical: bool) -> dict:
    """The SyncBatchNorm, stateful-step and dropout cases of one job."""
    res = {f"bn/{k}": v for k, v in run_sync_bn(rank, world).items()}
    res.update(run_stateful_step(rank, world, state, hierarchical))
    res.update(run_dropout_masks(rank, world))
    return res


# ---------------------------------------------------------------------------
# BERT, the bucketed exchange, int8, ZeRO-1 and Adasum
# (tests/test_torch_{bert,bucketing,zero,adasum}.py)

BERT_CFG = dict(vocab=97, layers=2, hidden=32, heads=4, mlp_dim=64,
                max_len=64)
BERT_T = 64


def bert_batch(world: int) -> dict:
    """Random tokens and labels, 2 sequences of BERT_T per replica."""
    rng = np.random.RandomState(51)
    return {k: rng.randint(0, BERT_CFG["vocab"], (2 * world, BERT_T))
            .astype(np.int64) for k in ("tokens", "labels")}


def run_bert_dp_step(rank: int, world: int, state: dict,
                     compression: str) -> dict:
    """One make_train_step step of the tiny BERT (fp32, flash route) with
    AdamW on this rank's shard of ``bert_batch``."""
    from horovod_tpu_torch.models.transformer import BertEncoder, mlm_loss
    model = BertEncoder(dtype=torch.float32, use_flash=True, **BERT_CFG)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    batch = {k: torch.tensor(v) for k, v in bert_batch(world).items()}
    return _adamw_step(model, mlm_loss, batch, compression)


# wire format -> bucket bounds of the bucketed-exchange cases (0: off)
BUCKET_WIRES = ("none", "bf16", "int8")
BUCKET_BOUNDS = (0, 4096, 1 << 30)
BUCKET_STEPS = 2


class WithUnused(torch.nn.Module):
    """The tiny GPT with a parameter the loss never uses (it gets no
    gradient)."""

    def __init__(self):
        super().__init__()
        from horovod_tpu_torch.models.gpt import GptDecoder
        self.gpt = GptDecoder(dtype=torch.float32, **GPT_CFG)
        self.unused = torch.nn.Parameter(torch.ones(5))

    def forward(self, tokens):
        return self.gpt(tokens)


def gpt_tokens(world: int) -> np.ndarray:
    return np.random.RandomState(53).randint(
        0, GPT_CFG["vocab"], (2 * world, 128)).astype(np.int64)


def gpt_state() -> dict:
    """Weights of the tiny GPT from the port's own init, seed 7."""
    from horovod_tpu_torch.models.gpt import GptDecoder
    model = GptDecoder(dtype=torch.float32, **GPT_CFG)
    model.reset_parameters(torch.Generator().manual_seed(7))
    return {k: v.numpy() for k, v in model.state_dict().items()}


BUCKET_LR = 0.05


def bucketed_run(state: dict, world: int, wire: str, sharded: bool,
                 bound: int, **kw) -> dict:
    """BUCKET_STEPS steps of the tiny GPT (with an unused parameter) from
    ``state``, SGD with momentum, replicated or ZeRO-1; params, their
    change (``delta/``), losses and the units launched before the last
    gradient hook."""
    from horovod_tpu_torch import Compression
    from horovod_tpu_torch.models.gpt import lm_loss
    from horovod_tpu_torch.parallel import dp, zero
    model = WithUnused()
    model.gpt.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    def make(ps):
        return torch.optim.SGD(ps, lr=BUCKET_LR, momentum=0.9)
    opt = zero.sharded_optimizer(model, make, bucket_bytes=bound) \
        if sharded else make(model.parameters())
    step = dp.make_train_step(
        model, lambda m, t: lm_loss(m.gpt, t), opt, device=_device(),
        compression=getattr(Compression, wire), sharded_update=sharded,
        bucket_bytes=bound, **kw)
    batch = dp.shard_batch(torch.tensor(gpt_tokens(world)))
    losses = [step(batch).loss.item() for _ in range(BUCKET_STEPS)]
    res = {f"param/{n}": _np(p) for n, p in model.named_parameters()}
    res.update({f"delta/{n}": _np(p.detach() - start[n].to(p.device))
                for n, p in model.named_parameters()})
    res.update(losses=np.array(losses),
               early=np.array(step.exchange.early_launches),
               units=np.array(len(step.exchange.units)))
    return res


def run_bucketing(rank: int, world: int, state: dict) -> dict:
    """Every (wire, replicated or sharded, bound) of the bucketed-exchange
    cases, keyed ``wire|sharded|bound|key``; then ``remat|...`` (bound
    4096, fp32, replicated, with ``remat``)."""
    out = {}
    for wire in BUCKET_WIRES:
        for sharded in (False, True):
            for bound in BUCKET_BOUNDS:
                res = bucketed_run(state, world, wire, sharded, bound)
                out.update({f"{wire}|{int(sharded)}|{bound}|{k}": v
                            for k, v in res.items()})
    res = bucketed_run(state, world, "none", False, 4096, remat=True)
    out.update({f"remat|{k}": v for k, v in res.items()})
    return out


class OddParams(torch.nn.Module):
    """The reference ZeRO tests' odd-sized parameters (nothing divides the
    shard counts; test_zero_sharding.py:27-35) and their quadratic loss."""

    def __init__(self):
        super().__init__()
        rs = np.random.RandomState(0)
        vec, mat, deep_w = [torch.tensor(rs.randn(*shape)).float()
                            for shape in ((13,), (5, 7), (3, 11))]
        # registered in the reference tree's leaf order (sorted keys): the
        # fused and bucketed layouts, and so the int8 blocks, then match
        self.deep_w = torch.nn.Parameter(deep_w)
        self.mat = torch.nn.Parameter(mat)
        self.scalar = torch.nn.Parameter(torch.tensor(0.7))
        self.vec = torch.nn.Parameter(vec)

    @staticmethod
    def loss(m, batch):
        total = sum((p ** 2).sum() for p in m.parameters())
        pred = batch["x"] * m.scalar
        return ((pred - batch["y"]) ** 2).mean() + 0.01 * total, {}


# OddParams name -> the reference's flattened key
ODD_KEYS = {"scalar": "scalar", "vec": "vec", "mat": "mat",
            "deep_w": "deep/w"}


def odd_batch(n: int = 32) -> dict:
    rs = np.random.RandomState(1)
    return {"x": rs.rand(n).astype(np.float32),
            "y": rs.rand(n).astype(np.float32)}


ODD_OPTS = {"sgd_momentum": lambda ps: torch.optim.SGD(ps, lr=0.1,
                                                       momentum=0.9),
            "adam": lambda ps: torch.optim.Adam(ps, lr=1e-2),
            "sgd": lambda ps: torch.optim.SGD(ps, lr=0.1),
            "sgd_05_momentum": lambda ps: torch.optim.SGD(ps, lr=0.05,
                                                          momentum=0.9)}


def odd_run(opt_name: str, steps: int, **kw) -> dict:
    """``steps`` steps of OddParams from its fixed start on this rank's
    shard of ``odd_batch``: params and losses."""
    from horovod_tpu_torch.parallel import dp, zero
    model = OddParams()
    make = ODD_OPTS[opt_name]
    opt = zero.sharded_optimizer(
        model, make, bucket_bytes=kw.get("bucket_bytes")) \
        if kw.get("sharded_update") else make(model.parameters())
    step = dp.make_train_step(model, OddParams.loss, opt, device=_device(),
                              **kw)
    batch = dp.shard_batch({k: torch.tensor(v)
                            for k, v in odd_batch().items()})
    losses = [step(batch).loss.item() for _ in range(steps)]
    res = {f"param/{n}": _np(p) for n, p in model.named_parameters()}
    res["losses"] = np.array(losses)
    if kw.get("sharded_update"):
        res["state_bytes"] = np.array(opt.state_bytes())
    else:
        res["state_bytes"] = np.array(sum(
            v.numel() * v.element_size() for st in opt.state.values()
            for v in st.values() if torch.is_tensor(v)))
    return res


class TinyBN(torch.nn.Module):
    """Dense(8) -> BatchNorm -> Dense(3), as the reference's sharded
    stateful test (test_zero_sharding.py:111-116)."""

    def __init__(self):
        super().__init__()
        from horovod_tpu_torch.models.resnet import BatchNorm
        from horovod_tpu_torch.models.transformer import Dense
        self.dense0 = Dense(4, 8, torch.float32)
        self.bn = BatchNorm(8)
        self.dense1 = Dense(8, 3, torch.float32)
        g = torch.Generator().manual_seed(0)
        for d in (self.dense0, self.dense1):
            torch.nn.init.normal_(d.weight, 0.0, 0.5, generator=g)

    def forward(self, x, train=False):
        return self.dense1(self.bn(self.dense0(x), train))


def stateful_sharded_run(sharded: bool, steps: int = 4) -> dict:
    import torch.nn.functional as F
    from horovod_tpu_torch.parallel import dp, zero
    model = TinyBN()

    def make(ps):
        return torch.optim.SGD(ps, lr=0.1)
    opt = zero.sharded_optimizer(model, make) if sharded \
        else make(model.parameters())
    step = dp.make_stateful_train_step(
        model, lambda m, b: (F.cross_entropy(m(b["x"], train=True),
                                             b["y"]), {}),
        opt, device=_device(), sharded_update=sharded)
    rs = np.random.RandomState(0)
    batch = dp.shard_batch({"x": torch.tensor(rs.rand(16, 4)).float(),
                            "y": torch.tensor(rs.randint(0, 3, 16))})
    losses = [step(batch).loss.item() for _ in range(steps)]
    res = {f"param/{n}": _np(p) for n, p in model.named_parameters()}
    res.update({f"stats/{n}": _np(b) for n, b in model.named_buffers()})
    res["losses"] = np.array(losses)
    return res


# the int8 steps held against the reference's: name -> (sharded_update,
# bucket_bytes). OddParams at 64 bytes makes three buckets: (vec, scalar),
# (mat), (deep_w)
INT8_STEPS = {"int8_step|0|0": (False, 0), "int8_step|0|64": (False, 64),
              "int8_step|1|0": (True, 0), "int8_step|1|64": (True, 64)}
INT8_STEP_OPT = "sgd_momentum"
INT8_STEP_COUNT = 2

QUANT_COLS = 333


def quant_input(world: int) -> np.ndarray:
    """[world, QUANT_COLS]: one awkward-length row per replica."""
    return np.random.RandomState(5).randn(world, QUANT_COLS) \
        .astype(np.float32)


def run_zero(rank: int, world: int) -> dict:
    """ZeRO-1 against the replicated step (SGD-momentum and Adam, 3 steps;
    ``opt|sharded|key``), the optimizer state size, the int8 steps, the
    sharded bf16 wire, the stateful sharded step, and the quantized
    allreduce of ``quant_input``."""
    from horovod_tpu_torch import Compression
    from horovod_tpu_torch.parallel import collectives as c
    out = {}

    def put(prefix, res):
        out.update({f"{prefix}|{k}": v for k, v in res.items()})
    for opt_name in ("sgd_momentum", "adam"):
        for sharded in (False, True):
            put(f"{opt_name}|{int(sharded)}",
                odd_run(opt_name, 3, sharded_update=sharded))
    put("int8_sharded", odd_run("sgd_05_momentum", 6, sharded_update=True,
                                compression=Compression.int8))
    for name, kw in (("exact", {}), ("int8", dict(compression=Compression.int8)),
                     ("exact_sharded", dict(sharded_update=True)),
                     ("bf16_sharded", dict(sharded_update=True,
                                           compression=Compression.bf16))):
        put(name, odd_run("sgd", 1, **kw))
    for name, (sharded, bound) in INT8_STEPS.items():
        put(name, odd_run(INT8_STEP_OPT, INT8_STEP_COUNT,
                          sharded_update=sharded, bucket_bytes=bound,
                          compression=Compression.int8))
    for sharded in (False, True):
        put(f"stateful|{int(sharded)}", stateful_sharded_run(sharded))
    x = torch.tensor(quant_input(world)[rank]).to(_device())
    for axis in (("data", "fsdp"), ("fsdp", "data")):
        out[f"quant|{axis_tag(axis)}"] = _np(c.quantized_allreduce(
            x, op=c.Average, axis=axis))
    return out


ADASUM_SHAPES = ((5,), (3, 4), (7,))


def adasum_inputs(world: int) -> list:
    """Per-rank inputs of the Adasum group case: [world, *shape] each."""
    rng = np.random.RandomState(61)
    return [rng.randn(world, *shape).astype(np.float32)
            for shape in ADASUM_SHAPES]


# axes each world runs the Adasum cases over
ADASUM_AXES = {2: [("data", "fsdp"), "data"],
               4: [("data", "fsdp"), ("fsdp", "data"), "data", "fsdp"]}


def run_adasum(rank: int, world: int) -> dict:
    """adasum_allreduce_group of ``adasum_inputs`` over each axis of
    ADASUM_AXES (``group|tag|i``), allreduce(op=Adasum) with scaling and
    grouped_allreduce(op=Adasum), one Adasum train step of OddParams with
    SGD; at world 3 the error each raises."""
    from horovod_tpu_torch.parallel import collectives as c
    from horovod_tpu_torch.parallel.adasum import adasum_allreduce_group
    xs = [torch.tensor(v[rank]).to(_device()) for v in adasum_inputs(world)]
    out = {}
    if world & (world - 1):
        for name, fn in (("group", lambda: adasum_allreduce_group(xs)),
                         ("allreduce", lambda: c.allreduce(xs[0],
                                                           op=c.Adasum))):
            try:
                fn()
                out[f"raised|{name}"] = np.array("")
            except ValueError as err:
                out[f"raised|{name}"] = np.array(str(err))
        return out
    for axis in ADASUM_AXES[world]:
        for i, y in enumerate(adasum_allreduce_group(xs, axis)):
            out[f"group|{axis_tag(axis)}|{i}"] = _np(y)
    both = ("data", "fsdp")
    out["allreduce_scaled"] = _np(c.allreduce(
        xs[1], op=c.Adasum, axis=both, prescale_factor=0.5,
        postscale_factor=3.0))
    for i, y in enumerate(c.grouped_allreduce(xs, op=c.Adasum, axis=both)):
        out[f"grouped|{i}"] = _np(y)
    out.update({f"step|{k}": v for k, v in
                odd_run("sgd", 1, op=c.Adasum).items()})
    return out


# ---------------------------------------------------------------------------
# the name-negotiated eager ops (tests/test_torch_eager.py)

EAGER_DTYPES = ("float32", "int32", "bfloat16", "float16")
EAGER_TIMEOUT = 10.0  # seconds each op may take, far under the ring's 15
# alltoall splits[src][dst] of the uneven case (the reference's at world 4)
EAGER_SPLITS = {2: [[1, 2], [3, 0]],
                4: [[1, 2, 0, 1], [2, 1, 1, 0], [0, 1, 2, 1], [1, 0, 1, 2]]}


def eager_values(seed: int, shape, dtype: str) -> np.ndarray:
    """float32 values every dtype of EAGER_DTYPES holds exactly."""
    rs = np.random.RandomState(seed)
    if dtype == "int32":
        return rs.randint(-20, 20, shape).astype(np.float32)
    return (rs.randint(-40, 40, shape) * 0.25).astype(np.float32)


def _op(name, kind, x, dtype, **kw) -> dict:
    return dict(name=name, type=kind, x=x, dtype=dtype, **kw)


def eager_cases(world: int) -> dict:
    """case -> one list of ops per rank, in that rank's submission order.
    An op is a dict: ``name``, ``type`` (allreduce, grouped, allgather,
    broadcast, alltoall), ``x`` (float32 values; a list for grouped),
    ``dtype`` and the op's own keys (``op``, ``prescale``, ``postscale``,
    ``root``, ``splits``)."""
    cases = {}
    ranks = range(world)
    for i, dt in enumerate(EAGER_DTYPES):
        seed = 1000 + 100 * i
        cases[f"sum|{dt}"] = [[_op("t", "allreduce", eager_values(
            seed + r, (2, 3), dt), dt, op="Sum")] for r in ranks]
        cases[f"allgather_ragged|{dt}"] = [[_op("ag", "allgather", eager_values(
            seed + 10 + r, (r + 1, 2), dt), dt)] for r in ranks]
        cases[f"broadcast_root|{dt}"] = [[_op("bc", "broadcast", eager_values(
            seed + 20 + r, (3, 3), dt), dt, root=world // 2)] for r in ranks]
        cases[f"alltoall_even|{dt}"] = [[_op("a2a", "alltoall", eager_values(
            seed + 30 + r, (2 * world, 2), dt), dt)] for r in ranks]
    for name, dt, op, pre, post in (
            ("average_scaled", "float32", "Average", 2.0, 0.5),
            ("average_scaled", "int32", "Average", 3.0, 0.5),
            ("average", "int32", "Average", 1.0, 1.0),
            ("min", "float32", "Min", 1.0, 1.0),
            ("min", "int32", "Min", 1.0, 1.0),
            ("max", "float32", "Max", 1.0, 1.0),
            ("max", "bfloat16", "Max", 1.0, 1.0),
            ("product", "float32", "Product", 1.0, 1.0),
            ("product", "int32", "Product", 1.0, 1.0)):
        cases[f"{name}|{dt}"] = [[_op("r", "allreduce", eager_values(
            hash_seed(name, dt, r), (4,), dt), dt, op=op, prescale=pre,
            postscale=post)] for r in ranks]
    cases["alltoall_uneven|float32"] = [[_op(
        "a2av", "alltoall", eager_values(2000 + r, (
            sum(EAGER_SPLITS[world][r]), 3), "float32"), "float32",
        splits=EAGER_SPLITS[world][r])] for r in ranks]
    # five tensors of three dtypes submitted together: fused per dtype
    cases["fused_mixed|mixed"] = [[_op(
        f"fz{i}", "allreduce", eager_values(3000 + 10 * i + r, (3 + i,), dt),
        dt, op="Sum") for i, dt in enumerate(
            ("float32", "int32", "float32", "bfloat16", "float32"))]
        for r in ranks]
    cases["grouped|float32"] = [[_op("grp", "grouped", [
        eager_values(4000 + 10 * i + r, (2 + i,), "float32")
        for i in range(3)], "float32", op="Average")] for r in ranks]
    # the same names, each rank in its own order
    names = [f"ooo{i}" for i in range(5)]
    cases["out_of_order|float32"] = [[_op(
        n, "allreduce", eager_values(5000 + 10 * int(n[3:]) + r, (4,),
                                     "float32"), "float32", op="Sum")
        for n in names[r % 5:] + names[:r % 5]][::(-1) ** r] for r in ranks]
    cases["adasum|float32"] = [[_op("ada", "allreduce", np.random.RandomState(
        6000 + r).uniform(-1, 1, 8).astype(np.float32), "float32",
        op="Adasum")] for r in ranks]
    return cases


def hash_seed(*parts) -> int:
    """A seed from strings and ints, the same in every process."""
    import zlib
    return zlib.crc32("/".join(map(str, parts)).encode()) & 0x7fffffff


def eager_submit(o: dict):
    """Submit one op of :func:`eager_cases` through the port's eager API;
    returns its handle (a list of handles for grouped)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import eager as e

    def tensor(x):
        return torch.tensor(x).to(getattr(torch, o["dtype"]))
    kind = o["type"]
    if kind in ("allreduce", "grouped"):
        kw = dict(name=o["name"], op=getattr(hvd, o["op"]),
                  prescale_factor=o.get("prescale", 1.0),
                  postscale_factor=o.get("postscale", 1.0))
        if kind == "grouped":
            return e.grouped_allreduce_async([tensor(x) for x in o["x"]],
                                             **kw)
        return e.allreduce_async(tensor(o["x"]), **kw)
    if kind == "allgather":
        return e.allgather_async(tensor(o["x"]), name=o["name"])
    if kind == "broadcast":
        return e.broadcast_async(tensor(o["x"]), o["root"], name=o["name"])
    return e.alltoall_async(tensor(o["x"]), splits=o.get("splits"),
                            name=o["name"])


def run_eager(rank: int, world: int) -> dict:
    """Every case of :func:`eager_cases` (all ops of a case submitted, then
    synchronized), the three join cases and a dtype mismatch; results as
    float64 under ``case|op name``."""
    import time
    from horovod_tpu_torch.common import eager as e
    out = {}

    def wait(h):
        return _np(e.synchronize(h, timeout=EAGER_TIMEOUT).double())
    for case, per_rank in eager_cases(world).items():
        handles = [(o, eager_submit(o)) for o in per_rank[rank]]
        for o, h in handles:
            if o["type"] == "grouped":
                for i, hi in enumerate(h):
                    out[f"{case}|{o['name']}.{i}"] = wait(hi)
                continue
            out[f"{case}|{o['name']}"] = wait(h)
            if h.aux:
                for kind, v in h.aux.items():
                    out[f"{case}|{o['name']}|{kind}"] = np.asarray(v)
    # join 1: rank world-1 joins; the others reduce with Min, Max, Product
    if rank == world - 1:
        e.join()
    else:
        for name in ("Min", "Max", "Product"):
            x = torch.tensor([rank + 1.0, -(rank + 1.0)])
            out[f"join_identity|{name}"] = wait(e.allreduce_async(
                x, name=f"j{name}", op=getattr(e, name)))
        e.join()
    # join 2: rank 2 % world joins; the others gather ragged rows
    if rank == 2 % world:
        e.join()
    else:
        out["join_allgather"] = wait(e.allgather_async(
            torch.full((rank + 1, 3), float(rank)), name="jgather"))
        e.join()
    # join 3: rank 1 joins conspicuously last
    time.sleep(0.05 * rank if rank != 1 else 1.0)
    out["join_last"] = np.array(e.join())
    # the ranks disagree on the dtype: every rank fails, naming the field
    x = torch.ones(3, dtype=torch.int32 if rank == 1 else torch.float32)
    try:
        e.synchronize(e.allreduce_async(x, name="bad"), timeout=EAGER_TIMEOUT)
        out["mismatch"] = np.array("")
    except e.HorovodInternalError as err:
        out["mismatch"] = np.array(str(err))
    return out


def run_eager_adasum(rank: int, world: int) -> dict:
    """The Adasum case of :func:`eager_cases` alone."""
    from horovod_tpu_torch.common import eager as e
    (o,) = eager_cases(world)["adasum|float32"][rank]
    return {"adasum": _np(e.synchronize(eager_submit(o),
                                        timeout=EAGER_TIMEOUT))}


# ---------------------------------------------------------------------------
# DistributedOptimizer, the int8 layout and zero-filled gradients
# (tests/test_torch_distributed_optimizer.py, test_torch_layout.py)
#
# The gradients are given, not computed: both frameworks then reduce and
# apply the same bits, and what is held against the reference is the
# exchange and the update, at rtol 1e-5. The values are multiples of 2^-10
# below 16 * 2^-10, so that every wire (fp16, bf16) and every order of
# summation over four replicas and two microsteps is exact; for the int8
# wire they are uniform floats instead, since grid values put many
# elements exactly halfway between two int8 levels.

MESHES = {1: (1, 1), 2: (2, 1), 4: (2, 2)}
GRAD_STEPS = 4
# the leaf whose gradient is zero on the reference's side and absent on
# the port's: a parameter the loss does not reach
ZERO_LEAF = {"gpt": ("LayerNorm_0", "scale"),
             "bert": ("LayerNorm_1", "scale"),
             "mnist": ("Dense_1", "kernel"), "resnet": ("head", "kernel")}
ZERO_KEY = {"gpt": "ln_f.weight", "bert": "ln_f.weight",
            "mnist": "dense1.weight", "resnet": "head.weight"}


def grid_grads(tree: dict, model: str, rank: int, step: int,
               smooth: bool = False, path=()) -> dict:
    """A gradient tree shaped like the flax ``tree``: multiples of 2^-10
    in [-15, 15] * 2^-10 (``smooth``: uniform in the same range), from a
    seed of the leaf, rank and step; zero at ``ZERO_LEAF[model]``."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = grid_grads(v, model, rank, step, smooth, p)
        elif p == ZERO_LEAF[model]:
            out[k] = np.zeros(np.shape(v), np.float32)
        else:
            rs = np.random.RandomState(hash_seed(*p, rank, step))
            g = rs.uniform(-15, 15, np.shape(v)) if smooth else \
                rs.randint(-15, 16, np.shape(v))
            out[k] = (g * 2.0 ** -10).astype(np.float32)
    return out


# XLA fuses the int8 exchange's dequantize-and-sum and its quantizer and
# rounds them in other last bits than any plain order of torch ops does;
# where that moves a value across the halfway point between two int8
# levels, the result differs by one level: about 5 in a million elements
# per quantization. ZeRO-1 also quantizes the update, the new shard less
# the old, whose last bits differ by far more relative to it: there up to
# 6 in 10,000 elements flip. A block layout other than the reference's
# moves a third to two thirds of them.
INT8_FLIP_RATE = 1e-3


def int8_mismatches(got: dict, want: dict, tol: dict) -> tuple:
    """``(elements outside tol, elements in all, largest difference
    there)`` of two dicts of arrays."""
    bad = total = 0
    worst = 0.0
    for n, w in want.items():
        d = np.abs(got[n] - w)
        out = d > tol["atol"] + tol["rtol"] * np.abs(w)
        bad += int(out.sum())
        total += w.size
        worst = max(worst, float(d[out].max()) if out.any() else 0.0)
    return bad, total, worst


def port_model(model: str):
    """The port's model of that name, fp32."""
    from horovod_tpu_torch.models import BertEncoder, MnistConvNet
    from horovod_tpu_torch.models.gpt import GptDecoder
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    if model == "gpt":
        return GptDecoder(dtype=torch.float32, **GPT_CFG)
    if model == "bert":
        return BertEncoder(dtype=torch.float32, **BERT_CFG)
    if model == "resnet":
        return ResNet(block_cls=BottleneckBlock, **RESNET_CFG)
    return MnistConvNet()


def from_flax(model: str, tree: dict) -> dict:
    from horovod_tpu_torch.models import convert
    return {"gpt": convert.from_flax_params, "bert": convert.from_flax_bert,
            "mnist": convert.from_flax_mnist,
            "resnet": convert.from_flax_resnet}[model](tree)


def given_grads_loss(model, batch):
    """A loss whose gradient is ``batch["g"]`` (this rank's slice): the
    inner product of the parameters with it."""
    g = batch["g"]
    total = sum((p * g[n][0]).sum() for n, p in model.named_parameters()
                if n in g)
    return total, {}


# name -> (optimizer, compression, op, backward passes, average the
# aggregate, predivide factor)
DOPT_CONFIGS = {
    "sgd": ("sgd", "none", "Average", 1, True, 1.0),
    "adamw": ("adamw", "none", "Average", 1, True, 1.0),
    "sgd_sum": ("sgd", "none", "Sum", 1, True, 1.0),
    "sgd_fp16": ("sgd", "fp16", "Average", 1, True, 1.0),
    "adamw_bf16": ("adamw", "bf16", "Average", 1, True, 1.0),
    "sgd_int8": ("sgd", "int8", "Average", 1, True, 1.0),
    "adamw_int8": ("adamw", "int8", "Average", 1, True, 1.0),
    "sgd_adasum": ("sgd", "none", "Adasum", 1, True, 1.0),
    "sgd_bpps2": ("sgd", "none", "Average", 2, True, 1.0),
    "adamw_bpps2_sum": ("adamw", "none", "Average", 2, False, 1.0),
    "sgd_bf16_bpps2_sum": ("sgd", "bf16", "Average", 2, False, 1.0),
    "sgd_predivide": ("sgd", "none", "Average", 1, True, 2.0),
    "adamw_int8_predivide_bpps2": ("adamw", "int8", "Average", 2, True,
                                   2.0),
}
# the configurations each model runs
DOPT_MODELS = {"mnist": tuple(DOPT_CONFIGS),
               "gpt": ("adamw", "sgd_fp16", "adamw_int8", "sgd_adasum",
                       "adamw_bpps2_sum", "adamw_int8_predivide_bpps2")}
DOPT_LR = {"sgd": 0.05, "adamw": 1e-2}
DOPT_WD = 0.1


def dopt_optimizer(name: str, params):
    if name == "sgd":
        return torch.optim.SGD(params, lr=DOPT_LR["sgd"], momentum=0.9)
    return torch.optim.AdamW(params, lr=DOPT_LR["adamw"],
                             weight_decay=DOPT_WD)


def dopt_run(model_name: str, tree: dict, cfg: str, rank: int, world: int,
             steps: int = GRAD_STEPS, resume_at: int = -1) -> dict:
    """``steps`` microsteps of DistributedOptimizer over the given grid
    gradients of this rank; the parameters after each (``k|name``). With
    ``resume_at`` k the run goes on after microstep k from a fresh model
    and optimizer loaded from the state_dicts."""
    import horovod_tpu_torch as hvd
    opt_name, wire, op, bpps, avg, pre = DOPT_CONFIGS[cfg]

    def build(state):
        model = port_model(model_name).to(_device())
        model.load_state_dict(state)
        opt = hvd.DistributedOptimizer(
            dopt_optimizer(opt_name, model.parameters()),
            op=getattr(hvd, op), compression=getattr(hvd.Compression, wire),
            backward_passes_per_step=bpps, average_aggregated_gradients=avg,
            gradient_predivide_factor=pre)
        return model, opt
    model, opt = build(from_flax(model_name, tree))
    zero_key = ZERO_KEY[model_name]
    out = {}
    for k in range(steps):
        grads = from_flax(model_name, grid_grads(tree, model_name, rank, k,
                                                 smooth=wire == "int8"))
        for n, p in model.named_parameters():
            p.grad = None if n == zero_key else grads[n].to(p.device)
        opt.step()
        opt.zero_grad()
        out.update({f"{k}|{n}": _np(p).copy()
                    for n, p in model.named_parameters()})
        if k == resume_at:
            saved = opt.state_dict()
            model, opt = build(model.state_dict())
            opt.load_state_dict(saved)
    return out


def mnist_tree(seed: int = 3) -> dict:
    """flax-shaped MNIST weights without JAX: the port's init from
    ``seed``, laid out back as the flax tree (for the card tests)."""
    from horovod_tpu_torch.models import MnistConvNet
    model = MnistConvNet()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = {}
    for j in range(2):
        tree[f"Conv_{j}"] = {
            "kernel": np.transpose(sd[f"conv{j}.weight"], (2, 3, 1, 0)),
            "bias": sd[f"conv{j}.bias"]}
        tree[f"Dense_{j}"] = {"kernel": sd[f"dense{j}.weight"].T.copy(),
                              "bias": sd[f"dense{j}.bias"]}
    return tree


def run_dist_opt(rank: int, world: int, trees: dict) -> dict:
    """Every configuration of DOPT_MODELS of the models of ``trees``:
    ``model|cfg|k|name``."""
    out = {}
    for model_name, tree in trees.items():
        for cfg in DOPT_MODELS[model_name]:
            res = dopt_run(model_name, tree, cfg, rank, world)
            out.update({f"{model_name}|{cfg}|{k}": v for k, v in res.items()})
    return out


# the int8 steps of the layout tests: name -> (sharded_update,
# bucket_bytes); 16 KiB cuts each model into several buckets
LAYOUT_STEPS = {"replicated": (False, 0), "replicated_bucketed": (False, 1 << 14),
                "zero1": (True, 0), "zero1_bucketed": (True, 1 << 14)}
LAYOUT_MODELS = ("gpt", "bert", "resnet")


def layout_step_run(model_name: str, tree: dict, world: int, sharded: bool,
                    bound: int, compression: str = "int8",
                    opt_name: str = "sgd", steps: int = 2) -> dict:
    """``steps`` make_train_step steps of the model from the flax weights
    ``tree``, on the given grid gradients (this rank's slice of each
    rank's), with the int8 wire (or ``compression``): the parameters."""
    from horovod_tpu_torch import Compression
    from horovod_tpu_torch.parallel import dp, zero
    model = port_model(model_name)
    model.load_state_dict(from_flax(model_name, tree), strict=False)
    zero_key = ZERO_KEY[model_name]

    def make(ps):
        return dopt_optimizer(opt_name, ps)
    opt = zero.sharded_optimizer(model, make, bucket_bytes=bound) \
        if sharded else make(model.parameters())
    step = dp.make_train_step(
        model, given_grads_loss, opt, device=_device(),
        compression=getattr(Compression, compression),
        sharded_update=sharded, bucket_bytes=bound)
    for k in range(steps):
        per_rank = [from_flax(model_name, grid_grads(
            tree, model_name, r, k, smooth=compression == "int8"))
            for r in range(world)]
        g = {n: torch.stack([pr[n] for pr in per_rank])
             for n in per_rank[0] if n != zero_key}
        step(dp.shard_batch({"g": g}))
    return {n: _np(p) for n, p in model.named_parameters()}


def run_layout(rank: int, world: int, trees: dict) -> dict:
    """Every LAYOUT_STEPS step of every LAYOUT_MODELS model, and the AdamW
    step with an unused parameter (``zero_fill|sharded``):
    ``model|step|name``."""
    out = {}
    for model_name in LAYOUT_MODELS:
        for name, (sharded, bound) in LAYOUT_STEPS.items():
            res = layout_step_run(model_name, trees[model_name], world,
                                  sharded, bound)
            out.update({f"{model_name}|{name}|{k}": v
                        for k, v in res.items()})
    for sharded in (False, True):
        res = layout_step_run("mnist", trees["mnist"], world, sharded, 0,
                              compression="none", opt_name="adamw")
        out.update({f"zero_fill|{int(sharded)}|{k}": v
                    for k, v in res.items()})
    return out


# ---------------------------------------------------------------------------
# the broadcast and object helpers (tests/test_torch_functions.py)

def run_functions(rank: int, world: int) -> dict:
    """broadcast_parameters of a state_dict, a tensor list and named
    parameters; broadcast_optimizer_state from a root that has stepped to
    ranks that have not (and of a DistributedOptimizer mid-accumulation);
    broadcast_object, allgather_object and metric_average. The root is the
    last rank."""
    import json
    import horovod_tpu_torch as hvd
    root = world - 1
    out = {}
    torch.manual_seed(100 + rank)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    hvd.broadcast_parameters(model.state_dict(), root_rank=root)
    out.update({f"sd/{n}": _np(p).copy() for n, p in model.named_parameters()})
    tensors = [torch.full((2, 2), float(rank)), torch.arange(3) + rank]
    hvd.broadcast_parameters(tensors, root_rank=root)
    out.update({f"list/{i}": _np(t) for i, t in enumerate(tensors)})
    other = torch.nn.Linear(2, 2)
    with torch.no_grad():
        other.weight.fill_(rank)
    hvd.broadcast_parameters(other.named_parameters(), root_rank=root)
    out["named/weight"] = _np(other.weight).copy()
    opt = torch.optim.AdamW(model.parameters(), lr=0.1 * (rank + 1),
                            weight_decay=0.01)
    if rank == root:
        for _ in range(2):
            opt.zero_grad()
            model(torch.ones(1, 4)).sum().backward()
            opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=root)
    state = opt.state_dict()
    out["opt/lr"] = np.array(state["param_groups"][0]["lr"])
    for i, st in state["state"].items():
        for k, v in st.items():
            out[f"opt/{i}/{k}"] = _np(v) if torch.is_tensor(v) \
                else np.array(v)
            if k == "step":
                out[f"opt/{i}/step_on_cpu"] = np.array(v.device.type == "cpu")
    dopt = hvd.DistributedOptimizer(torch.optim.SGD(
        other.parameters(), lr=0.1, momentum=0.9),
        backward_passes_per_step=2)
    if rank == root:
        other(torch.ones(1, 2)).sum().backward()
        dopt.step()  # one microstep: accumulated, not applied
    hvd.broadcast_optimizer_state(dopt, root_rank=root)
    dstate = dopt.state_dict()
    out["dopt/count"] = np.array(dstate["count"])
    out["dopt/accum0"] = _np(dstate["accum"][0])
    obj = {"rank": rank, "tags": ["a", "b"][:rank + 1]}
    out["object"] = np.array(json.dumps(hvd.broadcast_object(obj, root)))
    out["gathered"] = np.array(json.dumps(hvd.allgather_object(
        "x" * (rank + 1))))
    out["metric_average"] = _np(hvd.metric_average(float(rank + 1)))
    return out


# ---------------------------------------------------------------------------
# the remaining parallelism (tests/test_torch_sequence_parallel.py,
# test_torch_tp_pp.py, test_torch_expert_parallel.py): each job runs over
# one axis that spans the world

SP_SHAPE = (2, 64, 8, 32)  # B, T, H, D; D = 32 so the card runs it too
# (function, causal, flash)
SP_CASES = [(fn, causal, flash) for fn in ("ring", "ulysses")
            for causal in (False, True) for flash in (False, True)]


def sp_tag(fn: str, causal: bool, flash: bool) -> str:
    return f"{fn}|{int(causal)}|{int(flash)}"


def sp_inputs() -> list:
    """q, k, v and the loss weight w, each [B, T, H, D] float32."""
    rng = np.random.RandomState(30)
    return [rng.randn(*SP_SHAPE).astype(np.float32) for _ in range(4)]


def _seq_shard(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    per = x.shape[1] // world
    return x[:, rank * per:(rank + 1) * per]


def _attend(fn_name, causal, flash, q, k, v, w) -> dict:
    """o and the q/k/v gradients of sum(o * w)."""
    from horovod_tpu_torch.parallel import sp
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = getattr(sp, f"{fn_name}_attention")(*ins, causal=causal,
                                            use_flash=flash)
    grads = torch.autograd.grad((o * w).sum(), ins)
    return dict(zip(("o", "dq", "dk", "dv"), (o,) + grads))


def run_sp(rank: int, world: int) -> dict:
    """Every SP case on this rank's sequence shard; then the ring with a
    ``ppermute`` that records nothing for autograd (the mutation the
    tests hold the k/v gradients against)."""
    from horovod_tpu_torch.parallel import collectives as c
    dev = _device()
    q, k, v, w = (torch.tensor(_seq_shard(a, rank, world)).to(dev)
                  for a in sp_inputs())
    out = {}
    for fn, causal, flash in SP_CASES:
        for key, t in _attend(fn, causal, flash, q, k, v, w).items():
            out[f"{sp_tag(fn, causal, flash)}|{key}"] = _np(t)
    differentiable = c.ppermute
    c.ppermute = lambda x, perm, axis: c._ppermute(
        x.detach(), [(int(s), int(d)) for s, d in perm], axis)
    try:
        for flash in (False, True):
            res = _attend("ring", True, flash, q, k, v, w)
            for key in ("dk", "dv"):
                out[f"mutant|{int(flash)}|{key}"] = _np(res[key])
    finally:
        c.ppermute = differentiable
    return out


TP_DIMS = dict(b=4, d=16, h=64)


def tp_inputs() -> dict:
    rng = np.random.RandomState(31)
    d, h, b = TP_DIMS["d"], TP_DIMS["h"], TP_DIMS["b"]
    return {"x": rng.randn(b, d).astype(np.float32),
            "w_in": (rng.randn(d, h) * 0.3).astype(np.float32),
            "w_out": (rng.randn(h, d) * 0.3).astype(np.float32)}


def run_tp(rank: int, world: int) -> dict:
    """tp_mlp; the column/row pair's gradients (weights and input) of
    sum(y^2) with tanh between them; tp_mlp_inference on the fp32 and int8
    wires. Weights sliced as P(None, "model") / P("model", None)."""
    from horovod_tpu_torch import Compression
    from horovod_tpu_torch.parallel import tp
    dev = _device()
    a = {k: torch.tensor(v).to(dev) for k, v in tp_inputs().items()}
    per = TP_DIMS["h"] // world
    cols = slice(rank * per, (rank + 1) * per)
    w_in, w_out = a["w_in"][:, cols], a["w_out"][cols]
    out = {"mlp": _np(tp.tp_mlp(a["x"], w_in, w_out))}
    ins = [t.clone().requires_grad_(True) for t in (w_in, w_out, a["x"])]
    y = tp.row_parallel(torch.tanh(tp.column_parallel(ins[2], ins[0])),
                        ins[1])
    for key, g in zip(("dw_in", "dw_out", "dx"),
                      torch.autograd.grad((y ** 2).sum(), ins)):
        out[key] = _np(g)
    with torch.no_grad():
        out["infer_fp32"] = _np(tp.tp_mlp_inference(a["x"], w_in, w_out))
        out["infer_int8"] = _np(tp.tp_mlp_inference(
            a["x"], w_in, w_out, compression=Compression.int8))
    return out


PP_DIMS = dict(d=8, b=16, b_grad=8)


def pp_inputs(world: int) -> dict:
    rng = np.random.RandomState(32)
    d = PP_DIMS["d"]
    return {"ws": (rng.randn(world, d, d) * 0.5).astype(np.float32),
            "x": rng.randn(PP_DIMS["b"], d).astype(np.float32),
            "x_grad": rng.randn(PP_DIMS["b_grad"], d).astype(np.float32),
            "y": rng.randn(PP_DIMS["b_grad"], d).astype(np.float32)}


def pp_stage(w, h):
    return torch.tanh(h @ w)


def run_pp(rank: int, world: int) -> dict:
    """The pipeline at n_micro 4 and 8; the gradient of mean((out - y)^2)
    for this stage's weight at n_micro 4; the same in bf16."""
    from horovod_tpu_torch.parallel import pp
    dev = _device()
    a = {k: torch.tensor(v).to(dev) for k, v in pp_inputs(world).items()}
    w = a["ws"][rank]
    out = {f"fwd|{m}": _np(pp.pipeline_apply(pp_stage, w, a["x"], n_micro=m))
           for m in (4, 8)}
    wg = w.clone().requires_grad_(True)
    loss = ((pp.pipeline_apply(pp_stage, wg, a["x_grad"], n_micro=4) -
             a["y"]) ** 2).mean()
    out["grad"] = _np(torch.autograd.grad(loss, wg)[0])

    def bf16_stage(w, h):
        if h.dtype != torch.bfloat16:
            raise TypeError(f"stage got {h.dtype}")
        return torch.tanh(h @ w)
    y16 = pp.pipeline_apply(bf16_stage, w.bfloat16(),
                            a["x_grad"].bfloat16(), n_micro=4)
    out["bf16_dtype"] = np.array(str(y16.dtype))
    out["bf16"] = _np(y16.float())
    return out


EP_DIMS = dict(d=16, h=32, e_loc=2)
# case -> (tokens per rank, capacity factor)
EP_CASES = {"fwd": (16, None), "drop": (32, 0.25), "grad": (8, 4.0)}


def ep_inputs(world: int, case: str) -> dict:
    """Weights for ``world`` ranks of E_LOC experts and every rank's
    tokens [world, T_local, D]; a capacity factor of None means E_total
    (nothing drops)."""
    rng = np.random.RandomState(33 + sorted(EP_CASES).index(case))
    d, h = EP_DIMS["d"], EP_DIMS["h"]
    e = world * EP_DIMS["e_loc"]
    return {"w_gate": rng.randn(d, e).astype(np.float32),
            "w_in": (rng.randn(e, d, h) * 0.2).astype(np.float32),
            "w_out": (rng.randn(e, h, d) * 0.2).astype(np.float32),
            "x": rng.randn(world, EP_CASES[case][0], d).astype(np.float32)}


def run_ep(rank: int, world: int) -> dict:
    """moe_layer on this rank's tokens for each case; for "grad" the
    gradients of sum(out^2) for w_gate (this rank's own), the local
    expert weights and x."""
    from horovod_tpu_torch.parallel import ep
    dev = _device()
    e_loc = EP_DIMS["e_loc"]
    mine = slice(rank * e_loc, (rank + 1) * e_loc)
    out = {}
    for case, (_, cf) in EP_CASES.items():
        a = {k: torch.tensor(v).to(dev)
             for k, v in ep_inputs(world, case).items()}
        ins = [a["x"][rank].clone().requires_grad_(True),
               a["w_gate"].clone().requires_grad_(True),
               a["w_in"][mine].clone().requires_grad_(True),
               a["w_out"][mine].clone().requires_grad_(True)]
        y = ep.moe_layer(*ins, capacity_factor=cf or float(world * e_loc))
        out[case] = _np(y)
        if case == "grad":
            grads = torch.autograd.grad((y ** 2).sum(), ins)
            for key, g in zip(("dx", "dw_gate", "dw_in", "dw_out"), grads):
                out[f"grad|{key}"] = _np(g)
    return out


def run_par_full(rank: int, world: int, case: str) -> dict:
    """chip_smoke.py's parallel phase entries of one axis at full size
    (on the card): each rank computes the single-card result on its own
    card and compares its part; they raise on disagreement."""
    import json
    import chip_smoke
    dev = _device()
    counts = {k: 0 for k in chip_smoke.NAMES}
    p = chip_smoke.PAR
    run = {
        "seq": lambda: [
            chip_smoke.par_attention(dev, counts, "ring", True, p["t"]),
            chip_smoke.par_attention(dev, counts, "ring", False,
                                     p["t_plain"]),
            chip_smoke.par_attention(dev, counts, "ulysses", True, p["t"])],
        "model": lambda: [chip_smoke.par_tp(dev, counts)],
        "pipe": lambda: [chip_smoke.par_pipeline(dev, counts)],
        "expert": lambda: [
            chip_smoke.par_moe(dev, counts),
            chip_smoke.par_moe(dev, counts, chip_smoke.MOE["cf_drop"],
                               must_drop=True)],
    }[case]
    return {"entries": np.array(json.dumps(run())),
            "launches": np.array(json.dumps(counts))}


def worker(rank: int, world: int, store_path: str, out_path: str,
           job: str, job_args: tuple = (), mesh=None,
           device: str = "cpu") -> None:
    """Process entry: join a world of ``world`` through a FileStore (gloo
    on the CPU; NCCL on ``cuda:rank`` with ``device="cuda"``; with
    ``mesh=(data, fsdp)`` or a dict of ``MeshSpec`` sizes as that mesh),
    run ``job`` and save its results to ``out_path``."""
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(world)
    os.environ["HOROVOD_LOCAL_RANK"] = str(rank)
    os.environ["HOROVOD_FLASH_MIN_SEQ"] = "64"
    torch.set_num_threads(1)  # tiny tensors; leave the cores to the suite
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import MeshSpec
    if isinstance(mesh, dict):
        spec = MeshSpec(**mesh)
    else:
        spec = MeshSpec(data=mesh[0], fsdp=mesh[1]) if mesh else None
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    hvd.init(device=None if device == "cuda" else device,
             store=dist.FileStore(store_path, world), mesh_spec=spec)
    try:
        res = JOBS[job](rank, world, *job_args)
    finally:
        hvd.shutdown()
    np.savez(out_path, **res)


def spawn(world: int, tmp_dir, job: str, job_args: tuple = (),
          timeout: float = 120.0, mesh=None, device: str = "cpu") -> list:
    """Run ``job`` on ``world`` spawned processes; returns each rank's
    results as a dict."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp_dir), f"store_{job}")
    outs = [os.path.join(str(tmp_dir), f"{job}_{r}.npz")
            for r in range(world)]
    procs = [ctx.Process(target=worker,
                         args=(r, world, store, outs[r], job, job_args,
                               mesh, device))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} worker(s) of {job} timed out"
    assert all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [dict(np.load(o)) for o in outs]


JOBS = {"collectives": run_collectives, "dp": run_dp_step,
        "collectives_more": run_more_collectives, "stateful": run_stateful,
        "bert_dp": run_bert_dp_step, "bucketing": run_bucketing,
        "zero": run_zero, "adasum": run_adasum, "eager": run_eager,
        "eager_adasum": run_eager_adasum, "dist_opt": run_dist_opt,
        "layout": run_layout, "functions": run_functions, "sp": run_sp,
        "tp": run_tp, "pp": run_pp, "ep": run_ep,
        "par_full": run_par_full}
