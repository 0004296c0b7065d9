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


def worker(rank: int, world: int, store_path: str, out_path: str,
           job: str, job_args: tuple = ()) -> None:
    """Process entry: join a gloo world of ``world`` through a FileStore,
    run ``job`` and save its results to ``out_path``."""
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(world)
    os.environ["HOROVOD_LOCAL_RANK"] = str(rank)
    os.environ["HOROVOD_FLASH_MIN_SEQ"] = "64"
    torch.set_num_threads(1)  # tiny tensors; leave the cores to the suite
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", store=dist.FileStore(store_path, world))
    try:
        if job == "collectives":
            res = run_collectives(rank, world)
        else:
            res = run_dp_step(rank, world, *job_args)
    finally:
        hvd.shutdown()
    np.savez(out_path, **res)


def spawn(world: int, tmp_dir, job: str, job_args: tuple = (),
          timeout: float = 120.0) -> list:
    """Run ``job`` on ``world`` spawned processes; returns each rank's
    results as a dict."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp_dir), f"store_{job}")
    outs = [os.path.join(str(tmp_dir), f"{job}_{r}.npz")
            for r in range(world)]
    procs = [ctx.Process(target=worker,
                         args=(r, world, store, outs[r], job, job_args))
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
