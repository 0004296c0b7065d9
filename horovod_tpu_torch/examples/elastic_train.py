"""Elastic training: membership follows the discovery script.

Counterpart of ``examples/elastic/jax_elastic_train.py`` (reference:
examples/elastic/pytorch/pytorch_mnist_elastic.py): the ``elastic.run``
retry loop with committed state, surviving host additions, removals and
worker failures. ``--model mnist`` (the default) is the reference's
MnistConvNet with SGD(0.01, momentum 0.9), each rank on its own random
batch of 32, 200 steps, a commit every 10. ``--model gpt`` trains a GPT
(GPT-2 small at ``--vocab 50257 --layers 12 --hidden 768 --heads 12
--seq-len 1024 --batch-per-replica 8``) with AdamW on a batch drawn from
the step's seed and sharded over the replicas (``--fixed-batch``: one batch
for every step, drawn as ``gpt_train``'s corpus, so both scripts give the
same losses); ``--compression`` picks the gradient wire. The optimizer state is
replicated in ``elastic.State``; ``--zero1`` shards it (ZeRO-1) and holds
it in ``elastic.ShardedState``: on a resize the shards move live and a
dead rank's slice comes from its ring buddy's committed replica, so
training resumes from the live step.

``--fault-at STEP`` SIGKILLs the worker of rank ``--fault-rank`` once,
right after the commit of step STEP (``--fault-marker`` names the file
that records that it happened, so its respawn does not do it again): the
recovery demonstration. Every step prints one JSON line per rank, a
collective that fails prints a ``fault`` line, the sync after a re-init a
``recovered`` line (the old generation's shutdown by phase, the re-init's
and the sync's ends), and the end prints each rank's parameter digest and
optimizer step counts. ``--flight-dump DIR`` writes each rank's
flight-recorder ring there at the end (keep DIR apart from
``HOROVOD_FLIGHT_DIR``, where a failure's dumps land).

Run::

    python -m horovod_tpu_torch.runner.launch --min-np 2 --max-np 4 \\
        --host-discovery-script ./discover.sh -- \\
        python -m horovod_tpu_torch.examples.elastic_train
"""

import argparse
import hashlib
import json
import os
import signal
import sys
import time

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import dp, zero
from horovod_tpu_torch.runner.elastic import worker

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.examples.elastic_train")
    p.add_argument("--model", choices=("mnist", "gpt"), default="mnist")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--commit-every", type=int, default=10)
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 sharded optimizer state in ShardedState")
    p.add_argument("--batch-per-replica", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads (default hidden/32)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                   help="GPT compute dtype (parameters stay fp32)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and of the batches")
    p.add_argument("--fixed-batch", action="store_true",
                   help="GPT: one batch for every step, from --seed (as "
                        "gpt_train's corpus)")
    p.add_argument("--compression", choices=("none", "bf16", "fp16"),
                   default="none", help="the gradient wire")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on gloo (default: the card of this "
                        "process's local rank)")
    p.add_argument("--fault-at", type=int, default=None)
    p.add_argument("--fault-rank", type=int, default=0)
    p.add_argument("--fault-marker", default=None)
    p.add_argument("--flight-dump", default=None, metavar="DIR",
                   help="write each rank's flight-recorder dump to DIR at "
                        "the end")
    return p


def build(args, device):
    """(model, make_optimizer, loss_fn, batch_fn) of the chosen model."""
    g = torch.Generator().manual_seed(args.seed)
    if args.model == "mnist":
        from horovod_tpu_torch.models.mnist import MnistConvNet
        model = MnistConvNet()
        model.reset_parameters(g)

        def make_optimizer(params):
            return torch.optim.SGD(params, lr=0.01, momentum=0.9)

        def loss_fn(model, batch):
            return F.cross_entropy(model(batch["image"]),
                                   batch["label"]), {}

        def batch_fn(step):
            # each rank its own data, as the reference's RandomState(100
            # + rank) stream, drawn per step so a redo sees it again
            gen = torch.Generator().manual_seed(
                (args.seed + 1) * 100003 + 1009 * hvd.rank() + step)
            return {"image": torch.rand(32, 28, 28, 1, generator=gen),
                    "label": torch.randint(0, 10, (32,), generator=gen)}
        return model, make_optimizer, loss_fn, batch_fn

    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    heads = args.heads if args.heads is not None else args.hidden // 32
    model = GptDecoder(vocab=args.vocab, layers=args.layers,
                       hidden=args.hidden, heads=heads,
                       mlp_dim=args.hidden * 4, max_len=args.seq_len,
                       dtype=DTYPES[args.dtype])
    model.reset_parameters(g)

    def make_optimizer(params):
        return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    def batch_fn(step):
        if args.fixed_batch:
            gen = torch.Generator().manual_seed(args.seed)
            return dp.shard_batch(torch.randint(
                0, args.vocab, (args.batch_per_replica * hvd.size(),
                                args.seq_len), generator=gen))
        gen = torch.Generator().manual_seed(1000 * (args.seed + 1) + step)
        tokens = torch.randint(
            0, args.vocab, (args.batch_per_replica * hvd.size(),
                            args.seq_len), generator=gen)
        return dp.shard_batch(tokens)
    return model, make_optimizer, lm_loss, batch_fn


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    hvd.init(device=args.device)
    model, make_optimizer, loss_fn, batch_fn = build(args, args.device)
    wire = {"none": None, "bf16": hvd.Compression.bf16,
            "fp16": hvd.Compression.fp16}[args.compression]

    def make_step():
        """(optimizer, step) on the job as it is now: what a re-init or a
        resize rebuilds (ZeRO-1 builds its shards for the current
        world)."""
        if args.zero1:
            opt = zero.sharded_optimizer(model, make_optimizer)
            return opt, dp.make_train_step(model, loss_fn, opt,
                                           device=args.device,
                                           sharded_update=True,
                                           compression=wire)
        opt = make_optimizer(model.parameters())
        return opt, dp.make_train_step(model, loss_fn, opt,
                                       device=args.device,
                                       compression=wire)

    def report_recovery(state):
        """After the sync that follows a re-init: where the recovery went
        (the torn-down generation's shutdown by phase, then the re-init up
        to ``on_reset``, then the sync)."""
        reset_wall, state.reset_wall = getattr(state, "reset_wall", None), \
            None
        if reset_wall is not None:
            print(json.dumps({
                "recovered": True, "rank": hvd.rank(), "world": hvd.size(),
                "generation": worker.current_generation(),
                "shutdown": basics.shutdown_seconds(),
                "reset_wall": reset_wall, "pid": os.getpid(),
                "wall": time.time()}), flush=True)

    class Replicated(elastic.State):
        def on_reset(self):
            self.reset_wall = time.time()
            # the step over the new process groups, same optimizer
            self.step_fn = dp.make_train_step(model, loss_fn, self.optimizer,
                                              device=args.device,
                                              compression=wire)

        def sync(self):
            super().sync()
            report_recovery(self)

    class Sharded(elastic.ShardedState):
        def on_reset(self):
            self.reset_wall = time.time()
            self.opt, self.step_fn = make_step()

        def sync(self):
            super().sync()
            self.load_optimizer(self.opt)
            report_recovery(self)

    opt, step_fn = make_step()
    if args.zero1:
        state = Sharded.for_optimizer(opt, model=model, step=0)
        state.opt = opt
    else:
        state = Replicated(model=model, optimizer=opt, step=0)
    state.step_fn = step_fn
    fa.reset_launch_counts()

    @elastic.run
    def train(state):
        while state.step < args.steps:
            t0 = time.perf_counter()
            try:
                loss = state.step_fn(batch_fn(state.step)).loss.item()
            except elastic.HorovodInternalError as err:
                print(json.dumps({
                    "fault": type(err.__cause__ or err).__name__,
                    "message": str(err)[:300], "step": state.step + 1,
                    "rank": hvd.rank(), "world": hvd.size(),
                    "generation": worker.current_generation(),
                    "pid": os.getpid(), "wall": time.time()}), flush=True)
                raise
            step_ms = (time.perf_counter() - t0) * 1e3
            state.step += 1
            committed = state.step % args.commit_every == 0
            print(json.dumps({
                "step": state.step, "loss": loss, "step_ms": step_ms,
                "rank": hvd.rank(), "world": hvd.size(),
                "generation": worker.current_generation(),
                "device": str(hvd.device()), "committed": committed,
                "flash_launches": fa.launch_counts(),
                "pid": os.getpid(), "wall": time.time()}), flush=True)
            if committed:
                state.commit()  # checkpoint for elastic restore
                if state.step == args.fault_at and \
                        hvd.rank() == args.fault_rank and \
                        args.fault_marker and \
                        not os.path.exists(args.fault_marker):
                    with open(args.fault_marker, "w") as f:
                        json.dump({"step": state.step, "pid": os.getpid(),
                                   "rank": hvd.rank(),
                                   "wall": time.time()}, f)
                    os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(0.01)
        return state.step

    steps = train(state)
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    opt = state.opt.optimizer if args.zero1 else state.optimizer
    print(json.dumps({"done": True, "rank": hvd.rank(), "steps": steps,
                      "world": hvd.size(), "device": str(hvd.device()),
                      "param_sha256": digest.hexdigest(),
                      "optimizer_steps": sorted({
                          float(st["step"]) for st in opt.state.values()
                          if "step" in st}),
                      "pid": os.getpid()}), flush=True)
    if args.flight_dump:
        hvd.flight_dump(args.flight_dump)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
