"""BERT: the program's ``BertEncoder`` at a configuration's widths (attention
on the length-routed flash path), and its plain reference.

The reference is BERT's encoder as the port runs it (``assumed`` in the
configuration's file): token and position embeddings and their LayerNorm,
pre-LN bidirectional blocks with tanh-approximated GELU, a final LayerNorm,
an LM head tied to the token embedding with its own bias, cross entropy
against the labels averaged over every position.
"""

from __future__ import annotations

import torch

from portbench import flops, reference as ref
from portbench.models.gpt2 import block_spec


def shape(cfg: dict) -> dict:
    hidden, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"layers": cfg["num_hidden_layers"], "hidden": hidden,
            "heads": heads, "head_dim": hidden // heads,
            "v_head_dim": hidden // heads, "mlp": cfg["intermediate_size"],
            "vocab": cfg["vocab_size"],
            "max_len": cfg["max_position_embeddings"], "causal": False,
            "eps": cfg["assumed"]["layer_norm_eps"]}


def leaf_spec(cfg: dict) -> list:
    """(name, shape, init) of every parameter, by the program's names."""
    s = shape(cfg)
    h = s["hidden"]
    spec = [("embed", (s["vocab"], h), "embed"),
            ("pos_embed", (s["max_len"], h), "embed"),
            ("ln_embed.weight", (h,), "ones"),
            ("ln_embed.bias", (h,), "zeros")]
    for i in range(s["layers"]):
        spec += block_spec(i, h, s["mlp"])
    return spec + [("ln_f.weight", (h,), "ones"), ("ln_f.bias", (h,), "zeros"),
                   ("lm_bias", (s["vocab"],), "zeros")]


def program(cfg: dict, device):
    from horovod_tpu_torch.models.transformer import BertEncoder, mlm_loss
    s = shape(cfg)
    with torch.device(device):
        model = BertEncoder(vocab=s["vocab"], layers=s["layers"],
                            hidden=s["hidden"], heads=s["heads"],
                            mlp_dim=s["mlp"], max_len=s["max_len"],
                            dtype=getattr(torch, cfg["run"]["dtype"]),
                            use_flash=True)
    return model, mlm_loss


def program_batch(ids: torch.Tensor, labels: torch.Tensor):
    return {"tokens": ids, "labels": labels}


def step_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one rank's training step."""
    return flops.train_step_flops(shape(cfg), traffic["batch_per_rank"],
                                  traffic["seq_len"])


class Reference:
    def __init__(self, cfg: dict):
        self.s = shape(cfg)

    def positions(self, ids: torch.Tensor) -> int:
        return ids.numel()

    def loss_sum(self, w, ids, labels, mm):
        s = self.s
        t = ids.shape[1]
        x = w["embed"][ids] + w["pos_embed"][:t]
        x = ref.layer_norm(x, w["ln_embed.weight"], w["ln_embed.bias"],
                           s["eps"])
        for i in range(s["layers"]):
            x = ref.block(x, w, i, s["heads"], False, s["eps"], mm)
        x = ref.layer_norm(x, w["ln_f.weight"], w["ln_f.bias"], s["eps"])
        logits = mm(x.reshape(-1, s["hidden"]), w["embed"].t()) + \
            w["lm_bias"]
        return ref.cross_entropy_sum(logits, labels.reshape(-1))
