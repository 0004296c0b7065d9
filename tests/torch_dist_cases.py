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


def worker(rank: int, world: int, store_path: str, out_path: str,
           job: str, job_args: tuple = (), mesh=None,
           device: str = "cpu") -> None:
    """Process entry: join a world of ``world`` through a FileStore (gloo
    on the CPU; NCCL on ``cuda:rank`` with ``device="cuda"``; with
    ``mesh=(data, fsdp)`` as that mesh), run ``job`` and save its results
    to ``out_path``."""
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(world)
    os.environ["HOROVOD_LOCAL_RANK"] = str(rank)
    os.environ["HOROVOD_FLASH_MIN_SEQ"] = "64"
    torch.set_num_threads(1)  # tiny tensors; leave the cores to the suite
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import MeshSpec
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
        "zero": run_zero, "adasum": run_adasum}
