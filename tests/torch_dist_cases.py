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


def run_dp_step(rank: int, world: int, state: dict, tokens: np.ndarray,
                compression: str) -> dict:
    """One make_train_step step of the tiny GPT (fp32, flash path) on this
    rank's shard of ``tokens``; returns loss, params and AdamW moments."""
    from horovod_tpu_torch import Compression
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    from horovod_tpu_torch.parallel import dp
    model = GptDecoder(dtype=torch.float32, **GPT_CFG)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    step = dp.make_train_step(
        model, lm_loss, opt, device="cpu",
        compression=getattr(Compression, compression))
    out = step(dp.shard_batch(torch.tensor(tokens)))
    res = {"loss": out.loss.numpy()}
    for name, p in model.named_parameters():
        res[f"param/{name}"] = p.detach().numpy()
        res[f"mu/{name}"] = opt.state[p]["exp_avg"].numpy()
        res[f"nu/{name}"] = opt.state[p]["exp_avg_sq"].numpy()
    return res


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
             4: ["data", "fsdp", ("data", "fsdp")]}


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
        "collectives_more": run_more_collectives, "stateful": run_stateful}
