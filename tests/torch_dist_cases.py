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


# ---------------------------------------------------------------------------
# the serving plane's TP LM (tests/test_torch_serving_tp.py on gloo,
# tests/test_torch_cuda_dist.py on four cards)

SERVE_TP_DIMS = dict(vocab=64, hidden=32, mlp_dim=64, layers=2)
SERVE_ROWS = 16


def serve_inputs(vocab: int, rows: int = SERVE_ROWS, length: int = 32,
                 seed: int = 0):
    """``rows`` ragged prompts (1 to length - 1 tokens) padded to
    ``length``: (tokens [rows, length] int32, lengths [rows] int32)."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros((rows, length), np.int32)
    lengths = np.ones(rows, np.int32)
    for i in range(rows):
        n = rng.randint(1, length)
        tokens[i, :n] = rng.randint(0, vocab, n)
        lengths[i] = n
    return tokens, lengths


def run_serve_tp(rank: int, world: int, dims: dict, rows: int = SERVE_ROWS,
                 length: int = 32, keep_params: bool = True,
                 timed: bool = True) -> dict:
    """make_tp_lm_step over ``model`` on the fp32 and the int8 wire: this
    rank's weight shard (with ``keep_params``); on the group's first rank
    the last-position logits, the greedy tokens and (with ``timed``) the
    median ms of 5 steps of each wire (the others follow). With ``timed``
    the leader also reports the same model on its own device without a
    group (``axis=None``), on each wire."""
    import json
    import time
    from horovod_tpu_torch.serve.executor import make_tp_lm_step
    dev = _device()
    tokens, lengths = serve_inputs(dims["vocab"], rows, length)
    out = {}
    for wire in ("none", "int8"):
        step, info = make_tp_lm_step(compression=wire, device=dev, **dims)
        for k, v in step.model.state_dict().items() if keep_params else ():
            out[f"{wire}|param|{k}"] = _np(v)
        if not step.leader:
            out[f"{wire}|followed"] = np.array(step.follow())
            continue
        out[f"{wire}|logits"] = _np(step.logits(tokens, lengths))
        out[f"{wire}|tokens"] = step(tokens, lengths)
        times = []
        for _ in range(5 if timed else 0):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(tokens, lengths)
            times.append((time.perf_counter() - t0) * 1e3)
        if timed:
            out[f"{wire}|ms"] = np.array(sorted(times)[2])
        out[f"{wire}|info"] = np.array(json.dumps(info))
        step.stop()
    if rank == 0 and timed:
        for wire, key in (("none", "one"), ("int8", "one_int8")):
            one, _ = make_tp_lm_step(compression=wire, device=dev,
                                     axis=None, **dims)
            out[f"{key}|logits"] = _np(one.logits(tokens, lengths))
            out[f"{key}|tokens"] = one(tokens, lengths)
            del one
    return out


def serve_requests(vocab: int, n: int = 16, seed: int = 1) -> list:
    """``n`` prompts of 1 to 24 tokens from ``seed``."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(1, 25)).tolist()
            for _ in range(n)]


def greedy_decode(step, prompt: list, new_tokens: int, bucket: int,
                  batch: int) -> list:
    """A request decoded alone through ``step``, as the serving loop lays
    out a batch: row 0 holds it, the other rows one padding token."""
    seq = list(prompt)
    for _ in range(new_tokens):
        tokens = np.zeros((batch, bucket), np.int32)
        lengths = np.ones(batch, np.int32)
        tokens[0, :len(seq)] = seq
        lengths[0] = len(seq)
        seq.append(int(step(tokens, lengths)[0]))
    return seq[len(prompt):]


def run_serve_loop(rank: int, world: int, dims: dict, wire: str,
                   n_requests: int = 16, new_tokens: int = 4) -> dict:
    """The group's first rank serves ``n_requests`` through a batcher and
    a ServingLoop over make_tp_lm_step while the other ranks follow; then
    it decodes each prompt alone through the same step and stops the
    followers. Returns, on the first rank, every request's status and
    tokens and the alone-decoded tokens; on the others the steps
    followed."""
    from horovod_tpu_torch.metrics.registry import MetricsRegistry
    from horovod_tpu_torch.serve.batcher import ContinuousBatcher
    from horovod_tpu_torch.serve.executor import ServingLoop, make_tp_lm_step
    step, _ = make_tp_lm_step(compression=wire, device=_device(), **dims)
    if not step.leader:
        return {"followed": np.array(step.follow())}
    reg = MetricsRegistry()
    batcher = ContinuousBatcher(max_batch=8, queue_depth=64,
                                default_deadline_ms=120e3, max_len=64,
                                registry=reg)
    loop = ServingLoop(step, batcher, registry=reg).start()
    prompts = serve_requests(dims["vocab"], n_requests)
    try:
        reqs = [batcher.submit(p, max_new_tokens=new_tokens)
                for p in prompts]
        for r in reqs:
            r.wait(120.0)
    finally:
        loop.drain(timeout=60.0)
        loop.stop()
    out = {"status": np.array([r.status for r in reqs]),
           "tokens": np.array([r.generated for r in reqs]),
           "buckets": np.array([r.bucket for r in reqs])}
    out["alone"] = np.array([
        greedy_decode(step, p, new_tokens, r.bucket, batcher.max_batch)
        for p, r in zip(prompts, reqs)])
    step.stop()
    return out


def run_serve_fault(rank: int, world: int, dims: dict) -> dict:
    """The group's first rank serves through a ServingLoop over the int8
    step, whose second step fails on the leader after the step's
    broadcasts, inside its forward between the first and the second
    layer's reduction (a planted fault, as an OOM would). The loop must
    stop for good: the requests it carried and those queued fail, later
    submits are refused, and stop() sends nothing. The followers, left in
    the second layer's reduction, must fail out of follow() once the
    leader leaves the group. Returns the leader's statuses and the type of
    its fatal error; the followers' steps and error type."""
    from horovod_tpu_torch.metrics.registry import MetricsRegistry
    from horovod_tpu_torch.serve.batcher import (AdmissionRejected,
                                                 ContinuousBatcher)
    from horovod_tpu_torch.serve.executor import ServingLoop, make_tp_lm_step
    step, _ = make_tp_lm_step(compression="int8", device=_device(), **dims)
    if not step.leader:
        steps = 0
        try:
            steps = step.follow()
            error = ""
        except Exception as e:  # noqa: BLE001 — the error is the result
            error = type(e).__name__
        return {"followed": np.array(steps), "error": np.array(error)}
    calls = {"n": 0}
    mlp = step.model._mlp

    def planted(*args):
        calls["n"] += 1
        if calls["n"] == dims["layers"] + 2:  # step 2, its second layer
            raise RuntimeError("planted fault")
        return mlp(*args)
    step.model._mlp = planted
    reg = MetricsRegistry()
    batcher = ContinuousBatcher(max_batch=2, queue_depth=8,
                                default_deadline_ms=60e3, max_len=64,
                                registry=reg, vocab=dims["vocab"])
    reqs = [batcher.submit([1, 2, 3], max_new_tokens=4) for _ in range(4)]
    loop = ServingLoop(step, batcher, registry=reg).start()
    for r in reqs:
        r.wait(60.0)
    stopped = loop.join(30.0)
    try:
        batcher.submit([1], max_new_tokens=1)
        refused = False
    except AdmissionRejected:
        refused = True
    step.stop()
    loop.stop()
    return {"status": np.array([r.status for r in reqs]),
            "generated": np.array([len(r.generated) for r in reqs]),
            "fatal": np.array(type(loop.fatal).__name__),
            "stopped": np.array(stopped), "refused": np.array(refused),
            "closed": np.array(str(batcher.closed))}


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
        "par_full": run_par_full, "serve_tp": run_serve_tp,
        "serve_loop": run_serve_loop, "serve_fault": run_serve_fault}


# ---------------------------------------------------------------------------
# elastic: a stand-in for the driver (no JAX), its KV, and the jobs


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class StandInKV:
    """An HTTP key-value store serving what a worker's ``KVClient`` sends:
    GET (404 while a key is missing), PUT and DELETE of JSON bodies. The
    same in-process ``put_json``/``get_json``/``delete`` as the reference's
    ``KVServer``, so a :class:`StandInDriver` drives either."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self._store, lock = {}, threading.Lock()
        store = self._store

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, body=b""):
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                with lock:
                    val = store.get(self.path[1:])
                self._reply(404) if val is None else self._reply(200, val)

            def do_PUT(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with lock:
                    store[self.path[1:]] = body
                self._reply(200)

            def do_DELETE(self):
                with lock:
                    store.pop(self.path[1:], None)
                self._reply(200)

        self._lock = lock
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def put_json(self, key, value):
        import json
        with self._lock:
            self._store[key] = json.dumps(value).encode()

    def get_json(self, key):
        import json
        with self._lock:
            val = self._store.get(key)
        return None if val is None else json.loads(val)

    def delete(self, key):
        with self._lock:
            self._store.pop(key, None)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class StandInDriver:
    """The driver's half of the worker rendezvous, with the port's key
    functions: a generation's ``rank_and_size`` per slot (slots are
    ``(host, local_rank)`` in rank order, each with a fresh TCPStore
    endpoint), the ``generation`` and ``notify`` keys, and ``go`` once
    every slot has recorded READY. ``kv`` is a :class:`StandInKV` or the
    reference's ``KVServer``."""

    def __init__(self, kv):
        self.kv = kv
        self.gen = -1

    def publish(self, gen: int, slots, removed=()):
        from horovod_tpu_torch.common import kv_keys
        port = free_port()
        for rank, (host, slot) in enumerate(slots):
            self.kv.put_json(kv_keys.rank_and_size(gen, host, slot), {
                "rank": rank, "size": len(slots), "local_rank": slot,
                "local_size": len(slots), "cross_rank": 0, "cross_size": 1,
                "controller_addr": "127.0.0.1", "controller_port": port,
                "controller_data_port": port})
        for host, slot in removed:
            self.kv.put_json(kv_keys.rank_and_size(gen, host, slot),
                             {"removed": True})
        self.kv.put_json(kv_keys.generation(), {"generation": gen})
        self.gen = gen

    def release(self, gen: int, slots, timeout: float = 60.0):
        """``go`` for ``gen`` once every slot of ``slots`` is READY."""
        import time
        from horovod_tpu_torch.common import kv_keys
        deadline = time.monotonic() + timeout
        while not all((self.kv.get_json(kv_keys.worker_state(gen, h, s))
                       or {}).get("state") == "READY" for h, s in slots):
            if time.monotonic() > deadline:
                raise TimeoutError(f"generation {gen}: slots not READY")
            time.sleep(0.05)
        self.kv.put_json(kv_keys.go(gen), {"generation": gen})

    def wait_reset_request(self, gen: int, timeout: float = 60.0):
        import time
        from horovod_tpu_torch.common import kv_keys
        deadline = time.monotonic() + timeout
        while self.kv.get_json(kv_keys.reset_request(gen)) is None:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no reset request at generation {gen}")
            time.sleep(0.05)

    def notify(self, gen: int):
        from horovod_tpu_torch.common import kv_keys
        self.kv.put_json(kv_keys.notify(), {"generation": gen})


def start_member(target, args):
    """One started spawned process."""
    import torch.multiprocessing as mp
    proc = mp.get_context("spawn").Process(target=target, args=args)
    proc.start()
    return proc


def spawn_members(target, args_list, timeout: float):
    """Start one spawned process per argument tuple; returns the list of
    processes after joining them within ``timeout`` seconds in all (the
    ones still alive are killed and reported)."""
    import time
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [i for i, p in enumerate(procs) if p.is_alive()]
    for i in alive:
        procs[i].kill()
        procs[i].join()
    assert not alive, f"member(s) {alive} timed out"
    return procs


# -- ShardedState resize parity: the port's side ------------------------------
# Five members (A..E) go through one chain of resizes, the reference's
# ShardedState over tests/chaos.py's bus running the same chain in the test:
# world 4 -> 3 (D hard-killed, its slice from its buddy A) -> 4 (E joins
# fresh) -> 2 (B and E drain, handing their live shards off through the KV)
# -> 1 (C hard-killed, the lone survivor rebuilds from its buddy replica).

RESIZE_CHAIN = [
    {"members": [0, 1, 2, 3]},
    {"members": [0, 1, 2], "kill": [3]},
    {"members": [0, 1, 2, 4], "join": [4]},
    {"members": [0, 2], "drain": [1, 4]},
    {"members": [0], "kill": [2]},
]
RESIZE_N = 3000
RESIZE_BLOCK = 64


def resize_shard(world: int) -> int:
    return -(-RESIZE_N // (world * RESIZE_BLOCK)) * RESIZE_BLOCK


def resize_start(rank: int, world: int) -> dict:
    """The seeded moments a member holds at the start of the chain."""
    rng = np.random.RandomState(7 + rank)
    shard = resize_shard(world)
    return {"m": rng.randn(shard).astype(np.float32),
            "v": rng.rand(shard).astype(np.float32)}


def resize_train(opt: dict, phase: int, rank: int) -> dict:
    """The deterministic update between resizes (numpy on both sides)."""
    rng = np.random.RandomState(100 * phase + rank)
    m, v = np.asarray(opt["m"]), np.asarray(opt["v"])
    return {"m": (0.5 * m + rng.randn(m.size)).astype(np.float32),
            "v": (0.25 * v + rng.rand(v.size)).astype(np.float32)}


def resize_member(member: int, tmp: str, kv_port: int, wire: str) -> None:
    """One member of the chain on gloo: init each phase it belongs to (a
    FileStore per phase), ShardedState.sync, save its stacks, train,
    commit; die, drain or go on as the next phase says."""
    os.environ.update({"HOROVOD_RENDEZVOUS_ADDR": "127.0.0.1",
                       "HOROVOD_RENDEZVOUS_PORT": str(kv_port),
                       "HOROVOD_RESHARD_COMPRESSION": wire})
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.runner.elastic import preempt, worker
    state, out = None, {}
    for k, phase in enumerate(RESIZE_CHAIN):
        if member not in phase["members"]:
            continue
        world, rank = len(phase["members"]), phase["members"].index(member)
        os.environ.update({"HOROVOD_RANK": str(rank),
                           "HOROVOD_SIZE": str(world),
                           "HOROVOD_LOCAL_RANK": "0"})
        hvd.init(device="cpu",
                 store=dist.FileStore(os.path.join(tmp, f"store{k}"), world))
        if state is None:
            fresh = k > 0
            opt = {"m": np.zeros(resize_shard(world), np.float32),
                   "v": np.zeros(resize_shard(world), np.float32)} \
                if fresh else resize_start(rank, world)
            state = elastic.ShardedState(
                template=[torch.zeros(RESIZE_N)],
                sharded={"opt": {n: torch.from_numpy(a)
                                 for n, a in opt.items()}},
                block_size=RESIZE_BLOCK, params=torch.zeros(RESIZE_N),
                step=0 if fresh else 10)
        if k > 0:
            # the handoff fetch is an elastic worker's (KV) duty
            elastic_worker = worker.is_elastic_worker
            worker.is_elastic_worker = lambda: True
            try:
                state.sync()
            finally:
                worker.is_elastic_worker = elastic_worker
            for n, t in state.opt.items():
                out[f"p{k}/{n}"] = t.numpy().copy()
            out[f"p{k}/step"] = np.array(state.step)
            out[f"p{k}/params"] = state.params.numpy().copy()
        nxt = RESIZE_CHAIN[k + 1] if k + 1 < len(RESIZE_CHAIN) else {}
        if nxt:
            state.opt = {n: torch.from_numpy(a) for n, a in
                         resize_train(state.opt, k, rank).items()}
            with torch.no_grad():
                state.params += 1.0
            state.step += 1
            state.commit()
        if member in nxt.get("kill", ()):
            np.savez(os.path.join(tmp, f"member{member}.npz"), **out)
            os._exit(0)  # a hard kill: no shutdown, no goodbye
        if member in nxt.get("drain", ()):
            world_, old_rank, data = state.shard_handoff_payload()
            assert preempt.publish_handoff(world_, old_rank, data)
        hvd.shutdown()
        if member in nxt.get("drain", ()):
            break
    np.savez(os.path.join(tmp, f"member{member}.npz"), **out)


# -- failure translation: a peer that exits -----------------------------------


def fault_member(rank: int, world: int, store_path: str, out_path: str,
                 device: str) -> None:
    """World ``world``: one DP step together, then the last rank exits
    hard; rank 0 runs the next DP step (its gradient exchange has a dead
    peer), rank 1 an eager allreduce. Each survivor saves the error it got
    and how long it took to come."""
    import time
    os.environ.update({"HOROVOD_RANK": str(rank),
                       "HOROVOD_SIZE": str(world),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_ELASTIC": "1",
                       "HOROVOD_GLOO_TIMEOUT_SECONDS": "20"})
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    from horovod_tpu_torch.parallel import dp
    hvd.init(device=None if device == "cuda" else device,
             store=dist.FileStore(store_path, world))
    model = GptDecoder(dtype=torch.float32, **GPT_CFG)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    step = dp.make_train_step(model, lm_loss, opt,
                              device=None if device == "cuda" else device)
    tokens = torch.from_numpy(gpt_tokens(world)).long()
    step(dp.shard_batch(tokens))
    hvd.allreduce(torch.ones(2), name="warm")
    if rank == world - 1:
        os._exit(0)
    out = {}
    t0 = time.perf_counter()
    try:
        if rank == 0:
            step(dp.shard_batch(tokens))
        else:
            hvd.allreduce(torch.ones(2), name="after")
        out["error"] = np.array("none")
    except Exception as err:  # noqa: BLE001 — recorded for the test
        out["error"] = np.array(type(err).__name__)
        out["message"] = np.array(str(err)[:500])
    out["seconds"] = np.array(time.perf_counter() - t0)
    out["broken"] = np.array(hvd.common.basics._ctx.broken)
    t0 = time.perf_counter()
    hvd.shutdown()
    out["shutdown_seconds"] = np.array(time.perf_counter() - t0)
    np.savez(out_path, **out)


# -- GPT-2 (tiny) ZeRO-1 under elastic.run, a rank lost, and one joining -----

ELASTIC_GPT = dict(batch=12, commit_every=2, kill_after=3)


def elastic_gpt_tokens(step: int, vocab: int, seq: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(500 + step)
    return torch.randint(0, vocab, (ELASTIC_GPT["batch"], seq), generator=g)


def elastic_gpt_member(slot: int, kv_port: int, out_dir: str, wire: str,
                       device: str, victim: int, steps: int,
                       join_after: int = 0, model_name: str = "tiny",
                       trace_after: float = 50.0) -> None:
    """One elastic worker of the stand-in driver's job: the tiny GPT with
    ZeRO-1 AdamW under ``elastic.run``, a commit every two steps. Slot
    ``victim`` exits hard after step ``kill_after`` at the first world;
    with ``join_after`` the survivors wait after that step for the
    driver's notice of a joiner and take it at the next commit. Every
    resize is recorded (old live stacks, buddy replica, new stacks).
    ``model_name`` "small" trains GPT-2 small (bf16 compute) at seq 1024
    instead of the tiny GPT. Progress goes to ``trace<slot>.txt``, with
    every thread's stack if the member still runs after ``trace_after``
    seconds."""
    import json
    import time
    os.environ.update({
        "HOROVOD_ELASTIC": "1", "HOROVOD_RENDEZVOUS_ADDR": "127.0.0.1",
        "HOROVOD_RENDEZVOUS_PORT": str(kv_port),
        "HOROVOD_HOSTNAME": "localhost", "HOROVOD_LOCAL_RANK": str(slot),
        "HOROVOD_GLOO_TIMEOUT_SECONDS": "30" if device == "cuda" else "20",
        "HOROVOD_RESHARD_COMPRESSION": wire,
        "HOROVOD_ELASTIC_RETRY_BACKOFF_SECONDS": "0",
        "HOROVOD_FLASH_MIN_SEQ": "16"})
    torch.set_num_threads(1)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    import faulthandler
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    from horovod_tpu_torch.parallel import dp, zero
    from horovod_tpu_torch.runner.elastic import worker
    trace_file = open(os.path.join(out_dir, f"trace{slot}.txt"), "a",
                      buffering=1)
    # a member that hangs leaves its Python stacks behind
    faulthandler.enable(trace_file)
    faulthandler.dump_traceback_later(trace_after, exit=False,
                                      file=trace_file)

    def trace(msg):
        trace_file.write(f"{time.time():.3f} slot{slot} {msg}\n")

    def traced(name, fn):
        def run(*a, **kw):
            trace(f"{name} begin")
            out = fn(*a, **kw)
            trace(f"{name} end")
            return out
        return run

    basics.shutdown = traced("shutdown", basics.shutdown)
    basics.init = traced("init", basics.init)
    dev = None if device == "cuda" else device
    hvd.init(device=dev)
    trace(f"world {hvd.size()} rank {hvd.rank()}")
    if model_name == "small":
        from horovod_tpu_torch.models.gpt import GptSmall
        model = GptSmall(dtype=torch.bfloat16)
    else:
        model = GptDecoder(dtype=torch.float32, **GPT_CFG)
    model.reset_parameters(torch.Generator().manual_seed(0))
    vocab, seq = (50257, 1024) if model_name == "small" else \
        (GPT_CFG["vocab"], 32)
    first_world = hvd.size()
    records, log = [], {"losses": [], "events": [], "commit_ms": []}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def make(model):
        sopt = zero.sharded_optimizer(
            model, lambda ps: torch.optim.AdamW(ps, lr=LR))
        return sopt, dp.make_train_step(model, lm_loss, sopt, device=dev,
                                        sharded_update=True)

    class ZeroState(elastic.ShardedState):
        def on_reset(self):
            self.sopt, self.step_fn = make(model)

        def sync(self):
            trace(f"sync at world {hvd.size()}")
            # every generation after the first is a resize in this job
            rec = None
            if worker.current_generation() > 0:
                rec = {"gen": worker.current_generation(),
                       "old_world": self._world, "old_rank": self._old_rank,
                       "trained": bool(self._round),
                       "opt_step": [float(st["step"]) for st in
                                    self.optimizer.values()],
                       "old": self._combined_stacks(self._world)
                       if self._round else {},
                       "buddy": self._buddy, "t0": time.perf_counter()}
            super().sync()
            self.load_optimizer(self.sopt)
            if rec is not None:
                rec.update(new_world=hvd.size(), new_rank=hvd.rank(),
                           new=self._combined_stacks(hvd.size()),
                           seconds=time.perf_counter() - rec.pop("t0"))
                records.append(rec)

    sopt, step_fn = make(model)
    state = ZeroState.for_optimizer(sopt, model=model, step=0)
    state.sopt, state.step_fn = sopt, step_fn

    @elastic.run
    def train(state):
        while state.step < steps:
            tokens = elastic_gpt_tokens(state.step, vocab, seq)
            try:
                out = state.step_fn(dp.shard_batch(tokens))
            except elastic.HorovodInternalError as err:
                log["events"].append(("fault", state.step, hvd.size(),
                                      time.time(), str(err)[:300]))
                trace(f"fault at step {state.step}: {str(err)[:200]}")
                raise
            log["losses"].append(float(out.loss))
            trace(f"step {state.step + 1} done at world {hvd.size()}")
            state.step += 1
            if state.step % ELASTIC_GPT["commit_every"] == 0:
                sync()
                t0 = time.perf_counter()
                state.commit()
                sync()
                log["commit_ms"].append(
                    (hvd.size(), (time.perf_counter() - t0) * 1e3))
            if state.step == ELASTIC_GPT["kill_after"] and \
                    hvd.size() == first_world and slot == victim:
                sync()
                log["death"] = time.time()
                np.save(os.path.join(out_dir, "victim_log.npy"),
                        np.array(json.dumps(log)))
                np.savez(os.path.join(out_dir, f"slot{slot}.npz"),
                         log=np.array(json.dumps(log)))
                os._exit(0)  # a hard kill after a commit and one step
            if join_after and state.step == join_after and \
                    hvd.size() < first_world:
                open(os.path.join(out_dir, f"ready{slot}"), "w").close()
                while (worker.poll_notification() or 0) < 2:
                    time.sleep(0.05)
                elastic.notify_hosts_updated(generation=2)

    t0 = time.perf_counter()
    train(state)
    log["seconds"] = time.perf_counter() - t0
    trace("trained")
    faulthandler.cancel_dump_traceback_later()
    out = {"log": np.array(json.dumps(log)), "world": np.array(hvd.size()),
           "rank": np.array(hvd.rank()), "n_resizes": np.array(
               len(records))}
    for i, rec in enumerate(records):
        for k in ("gen", "old_world", "old_rank", "trained", "opt_step",
                  "new_world", "new_rank", "seconds"):
            out[f"r{i}/{k}"] = np.array(rec[k])
        for key, arr in rec["old"].items():
            out[f"r{i}/old/{key}"] = arr
        for key, arr in rec["new"].items():
            out[f"r{i}/new/{key}"] = arr
        buddy = rec["buddy"] or {}
        out[f"r{i}/buddy_of"] = np.array(-1 if buddy.get("of") is None
                                         else buddy["of"])
        for key, arr in (buddy.get("stacks") or {}).items():
            out[f"r{i}/buddy/{key}"] = arr
    for name, p in model.named_parameters():
        out[f"param/{name}"] = p.detach().cpu().numpy()
    from horovod_tpu_torch.metrics import get_registry
    out["metrics"] = np.array(json.dumps(get_registry().snapshot()))
    np.savez(os.path.join(out_dir, f"slot{slot}.npz"), **out)
    # the last shutdown, and the exit after it, must not hang either
    faulthandler.dump_traceback_later(60, exit=True, file=trace_file)
    basics.shutdown()
    trace("exiting")


def run_elastic_gpt(tmp, kv, wire, device="cpu", world=3, steps=6,
                    join_after=0, timeout=55, model="tiny"):
    """The stand-in driver's job: ``world`` slots, the last one killed
    after step 3; the survivors re-rendezvous at a new store endpoint and
    go on; with ``join_after`` a fresh slot joins after that step. Returns
    each slot's saved results."""
    import time
    driver = StandInDriver(kv)
    slots = [("localhost", s) for s in range(world)]
    victim = world - 1
    args = [(s, kv.port, str(tmp), wire, device, victim, steps, join_after,
             model, timeout - 20) for s in range(world)]
    errs = []

    def drive():
        try:
            driver.publish(0, slots)
            driver.release(0, slots, timeout)
            driver.wait_reset_request(0, timeout)
            driver.publish(1, slots[:-1], removed=slots[-1:])
            driver.release(1, slots[:-1], timeout)
            if join_after:
                deadline = time.monotonic() + timeout
                while not all((tmp / f"ready{s}").exists()
                              for s in range(world - 1)):
                    assert time.monotonic() < deadline, "no join point"
                    time.sleep(0.05)
                driver.joiner = start_member(
                    elastic_gpt_member, (victim, kv.port, str(tmp), wire,
                                         device, -1, steps, 0, model,
                                         timeout - 20))
                driver.publish(2, slots)
                driver.notify(2)
                driver.release(2, slots, timeout)
        except BaseException as e:  # noqa: BLE001 — raised below
            errs.append(e)

    import threading
    t = threading.Thread(target=drive, daemon=True)
    t.start()
    try:
        procs = spawn_members(elastic_gpt_member, args, timeout)
        t.join(10)
        joiner = getattr(driver, "joiner", None)
        if joiner is not None:
            joiner.join(timeout)
        if errs:
            raise errs[0]
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world and (
            joiner is None or joiner.exitcode == 0), codes
    except BaseException as err:
        traces = "".join(p.read_text() for p in sorted(tmp.glob("trace*")))
        raise AssertionError(f"{err!r}\n{traces}") from err
    return {s: dict(np.load(tmp / f"slot{s}.npz")) for s in range(world)}


def resize_record(saved, gen):
    """A slot's last record of the resize into generation ``gen``."""
    out = None
    for i in range(int(saved.get("n_resizes", 0))):
        if int(saved[f"r{i}/gen"]) == gen:
            out = {k[len(f"r{i}/"):]: v for k, v in saved.items()
                   if k.startswith(f"r{i}/")}
    return out


def moments_check(res, gen, wire):
    """The resize into generation ``gen``: the trained ranks held their
    optimizer state at the same step, and the gathered new moments equal
    their live shards plus a dead rank's committed shard from its buddy
    (bit-equal on fp32, within the codec's bound on int8)."""
    rec = {s: resize_record(saved, gen) for s, saved in res.items()}
    rec = {s: r for s, r in rec.items() if r is not None}
    trained = [s for s, r in rec.items() if bool(r["trained"])]
    # the live state is consistent: no rank stepped its shard further
    steps = {tuple(rec[s]["opt_step"]) for s in trained}
    assert len(steps) == 1, steps
    old_world = int(rec[trained[0]]["old_world"])
    by_old = {}
    for s in trained:
        r = rec[s]
        by_old[int(r["old_rank"])] = {k[4:]: v for k, v in r.items()
                                      if k.startswith("old/")}
        if int(r["buddy_of"]) >= 0:
            by_old.setdefault(int(r["buddy_of"]), {
                k[6:]: v for k, v in r.items() if k.startswith("buddy/")})
    assert sorted(by_old) == list(range(old_world))
    new = sorted(rec, key=lambda s: int(rec[s]["new_rank"]))
    assert len(new) == int(rec[new[0]]["new_world"])
    keys = sorted(by_old[0])
    assert keys
    for key in keys:
        old_flat = np.concatenate([by_old[r][key] for r in range(old_world)],
                                  axis=1)
        new_flat = np.concatenate([rec[s][f"new/{key}"] for s in new],
                                  axis=1)
        n = min(old_flat.shape[1], new_flat.shape[1])
        if wire == "int8":
            scale = np.abs(old_flat).max()
            assert np.abs(new_flat[:, :n] - old_flat[:, :n]).max() <= \
                scale / 127 + 1e-6
        else:
            np.testing.assert_array_equal(new_flat[:, :n], old_flat[:, :n])
