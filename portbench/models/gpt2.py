"""GPT-2: the program's ``GptDecoder`` at a configuration's widths, and its
plain reference.

The reference is GPT-2's decoder as the port runs it (``assumed`` in the
configuration's file): learned token and position embeddings, pre-LN causal
blocks with tanh-approximated GELU, a final LayerNorm and an LM head tied to
the token embedding, next-token cross entropy averaged over every position
that has a next token.
"""

from __future__ import annotations

import torch

from portbench import flops, reference as ref


def shape(cfg: dict) -> dict:
    hidden, heads = cfg["n_embd"], cfg["n_head"]
    return {"layers": cfg["n_layer"], "hidden": hidden, "heads": heads,
            "head_dim": hidden // heads, "v_head_dim": hidden // heads,
            "mlp": cfg["n_inner"] or 4 * hidden,
            "vocab": cfg["vocab_size"], "max_len": cfg["n_positions"],
            "causal": True, "eps": cfg["assumed"]["layer_norm_eps"]}


def block_spec(i: int, hidden: int, mlp: int) -> list:
    p = f"blocks.{i}."
    spec = [(p + "ln0.weight", (hidden,), "ones"),
            (p + "ln0.bias", (hidden,), "zeros")]
    for name in ("query", "key", "value", "out"):
        spec += [(p + f"attn.{name}.weight", (hidden, hidden), "lecun"),
                 (p + f"attn.{name}.bias", (hidden,), "zeros")]
    return spec + [(p + "ln1.weight", (hidden,), "ones"),
                   (p + "ln1.bias", (hidden,), "zeros"),
                   (p + "mlp0.weight", (mlp, hidden), "lecun"),
                   (p + "mlp0.bias", (mlp,), "zeros"),
                   (p + "mlp1.weight", (hidden, mlp), "lecun"),
                   (p + "mlp1.bias", (hidden,), "zeros")]


def leaf_spec(cfg: dict) -> list:
    """(name, shape, init) of every parameter, by the program's names."""
    s = shape(cfg)
    h = s["hidden"]
    spec = [("embed", (s["vocab"], h), "embed"),
            ("pos_embed", (s["max_len"], h), "embed")]
    for i in range(s["layers"]):
        spec += block_spec(i, h, s["mlp"])
    return spec + [("ln_f.weight", (h,), "ones"), ("ln_f.bias", (h,), "zeros")]


def program(cfg: dict, device):
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    s = shape(cfg)
    with torch.device(device):
        model = GptDecoder(vocab=s["vocab"], layers=s["layers"],
                           hidden=s["hidden"], heads=s["heads"],
                           mlp_dim=s["mlp"], max_len=s["max_len"],
                           dtype=getattr(torch, cfg["run"]["dtype"]),
                           use_flash=True)
    return model, lm_loss


def program_batch(ids: torch.Tensor, labels: torch.Tensor):
    """The language model's targets are its own next tokens."""
    return ids


def step_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one rank's training step."""
    return flops.train_step_flops(shape(cfg), traffic["batch_per_rank"],
                                  traffic["seq_len"])


class Reference:
    def __init__(self, cfg: dict):
        self.s = shape(cfg)

    def positions(self, ids: torch.Tensor) -> int:
        return ids.shape[0] * (ids.shape[1] - 1)

    def loss_sum(self, w, ids, labels, mm):
        s = self.s
        t = ids.shape[1]
        x = w["embed"][ids] + w["pos_embed"][:t]
        for i in range(s["layers"]):
            x = ref.block(x, w, i, s["heads"], True, s["eps"], mm)
        x = ref.layer_norm(x, w["ln_f.weight"], w["ln_f.bias"], s["eps"])
        logits = mm(x[:, :-1].reshape(-1, s["hidden"]), w["embed"].t())
        return ref.cross_entropy_sum(logits, ids[:, 1:].reshape(-1))
