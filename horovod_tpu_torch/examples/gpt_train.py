"""Data-parallel causal-LM training (GPT family) with flash attention.

Counterpart of ``examples/jax/jax_gpt_train.py``, with its flags plus
``--seed`` (the weights and the corpus), ``--dtype`` (compute; parameters
stay fp32) and ``--device`` (``cpu`` runs on gloo; the default is the
card of this process's local rank). A synthetic, memorizable corpus, AdamW
(lr 3e-4, weight decay 1e-4, as ``optax.adamw``) and the bf16 gradient
wire; the loss must fall. Every step prints one JSON line on rank 0: the
loss, the step's milliseconds (host time up to reading the loss), the
cumulative flash kernel launches and the wall time. ``--flight-dump DIR``
writes every rank's flight-recorder ring there at the end
(``flight_rank<R>.json``), the input of the step attributor
(``horovod_tpu_torch.obs.attribute``). ``--tune`` runs the steps under a
:class:`~horovod_tpu_torch.tune.TuningSession` over bucket bytes and
compression (rank 0 leads; the other ranks follow the epoch configs it
publishes to the launcher's rendezvous KV), rebuilding the step whenever
the session returns a config; every rank prints its config sequence.

Run, GPT-2 small on one card::

    python -m horovod_tpu_torch.runner.launch -np 1 -H localhost:1 -- \\
        python -m horovod_tpu_torch.examples.gpt_train --steps 5 \\
        --vocab 50257 --layers 12 --hidden 768 --heads 12 --seq-len 1024 \\
        --batch-per-replica 8 --dtype bfloat16
"""

import argparse
import json
import sys
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import dp

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.examples.gpt_train")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-per-replica", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads (default hidden/32; must divide "
                        "hidden)")
    p.add_argument("--remat", action="store_true",
                   help="recompute activations in backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--no-flash", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and of the corpus")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                   help="compute dtype (parameters stay fp32)")
    p.add_argument("--flight-dump", default=None, metavar="DIR",
                   help="write each rank's flight-recorder dump to DIR at "
                        "the end")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on gloo (default: the card of this "
                        "process's local rank)")
    p.add_argument("--tune", action="store_true",
                   help="tune bucket bytes and compression while training "
                        "(HOROVOD_TUNE_* set the epochs and the budget)")
    return p


def tuning_session(rank: int):
    """Rank 0 leads; the others follow through the rendezvous KV."""
    from horovod_tpu_torch.common.env import env_int, env_str
    from horovod_tpu_torch.runner.http_kv import KVClient
    from horovod_tpu_torch.tune import TuningSession, default_space
    addr = env_str("HOROVOD_RENDEZVOUS_ADDR")
    kv = KVClient(addr, env_int("HOROVOD_RENDEZVOUS_PORT")) if addr \
        else None
    return TuningSession(space=default_space(engine_knobs=False), kv=kv,
                         leader=rank == 0)


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    heads = args.heads if args.heads is not None else args.hidden // 32
    if heads < 1 or args.hidden % heads:
        p.error(f"--hidden {args.hidden} needs a head count that divides "
                f"it (got {heads}); pass --heads explicitly")
    hvd.init(device=args.device)
    try:
        model = GptDecoder(vocab=args.vocab, layers=args.layers,
                           hidden=args.hidden, heads=heads,
                           mlp_dim=args.hidden * 4, max_len=args.seq_len,
                           dtype=DTYPES[args.dtype],
                           use_flash=not args.no_flash)
        model.reset_parameters(torch.Generator().manual_seed(args.seed))
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        ts = tuning_session(hvd.rank()) if args.tune else None
        kwargs = ts.step_kwargs() if ts else dict(
            compression=hvd.Compression.bf16)
        step = dp.make_train_step(model, lm_loss, opt, device=args.device,
                                  remat=args.remat, **kwargs)
        # one fixed batch of the whole job, each replica training on its
        # slice: the loss visibly drops
        corpus = torch.randint(
            0, args.vocab, (args.batch_per_replica * hvd.size(),
                            args.seq_len),
            generator=torch.Generator().manual_seed(args.seed))
        batch = dp.shard_batch(corpus)
        fa.reset_launch_counts()
        losses, configs, times = [], [], []
        for i in range(args.steps):
            t0 = time.perf_counter()
            loss = step(batch).loss.item()  # waits for the step
            step_ms = (time.perf_counter() - t0) * 1e3
            losses.append(loss)
            times.append(step_ms)
            if ts is not None:
                configs.append(dict(ts.config))
                cfg = ts.on_step(loss)
                if cfg is not None:  # the staged rebuild
                    step = dp.make_train_step(model, lm_loss, opt,
                                              device=args.device,
                                              remat=args.remat,
                                              **ts.step_kwargs(cfg))
            if hvd.rank() == 0:
                print(json.dumps({
                    "step": i, "loss": loss, "step_ms": step_ms,
                    "flash_launches": fa.launch_counts(),
                    "world": hvd.size(), "device": str(hvd.device()),
                    "wall": time.time()}), flush=True)
        if ts is not None:
            print(json.dumps({
                "tune_rank": hvd.rank(), "configs": configs,
                "step_ms": times,
                "converged": ts.converged, "config": ts.config,
                "trace": [{"config": t["config"],
                           "objective": t["objective"]}
                          for t in ts._search.trace]}), flush=True)
        if not losses[-1] < losses[0]:
            print(f"gpt_train: the loss did not fall: {losses}",
                  file=sys.stderr)
            return 1
        if args.flight_dump:
            hvd.flight_dump(args.flight_dump)
        if hvd.rank() == 0:
            print(json.dumps({"done": True, "first_loss": losses[0],
                              "final_loss": losses[-1]}), flush=True)
        return 0
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    sys.exit(main())
