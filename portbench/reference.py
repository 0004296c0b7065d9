"""The plain reference of a training cell, and the numbers that decide
``correct``.

Plain PyTorch, written from the models' published equations and the port's
documented departures (``assumed`` in each configuration's file). It imports
nothing of the program and takes none of its outputs but the numbers it
judges. Every product runs in float32 with TF32 off, or, for the control
that these numbers must fail, in fp8 (``Fp8Matmul``: each operand rounded to
e4m3 with a per-tensor scale, gradients to e5m2, sums in float32).

A training step of the reference runs the batch in blocks of rows
(``BLOCK_TOKENS`` tokens at a time) and accumulates their gradients, so
that it fits beside nothing else on one card.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

BLOCK_TOKENS = 8192
# leaves whose reference gradient is below this share of the median leaf's
# move under Adam by round-off alone: the change of the parameters leaves
# them out
ROUNDOFF_GRAD_SHARE = 1e-3


# --------------------------------------------------------------------------
# products


def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under a per-tensor scale that maps its
    largest magnitude to the format's largest, back in float32."""
    top = torch.finfo(fmt).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).to(fmt).float() / scale


class Fp8Matmul(torch.autograd.Function):
    """``a @ b`` as an fp8 GEMM computes it: operands in e4m3, the
    incoming gradient in e5m2, accumulation in float32."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2)
        return (torch.matmul(g8, b8.transpose(-1, -2)),
                torch.matmul(a8.transpose(-1, -2), g8))


def matmul_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return Fp8Matmul.apply(a, b)


MATMULS = {"float32": matmul32, "fp8": matmul_fp8}


# --------------------------------------------------------------------------
# the pre-LN transformer


def linear(x, w, b, mm):
    """``x @ w^T + b`` with ``w`` in the ``[out, in]`` layout."""
    shape = x.shape[:-1]
    y = mm(x.reshape(-1, x.shape[-1]), w.t())
    return y.reshape(*shape, w.shape[0]) + b


def layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) *
                                       (x + 0.044715 * x ** 3)))


def attention(x, w, p, heads, causal, mm):
    """Multi-head self-attention of ``x`` [B, T, hidden] with the
    projections ``p + {query,key,value,out}``."""
    b, t, hidden = x.shape
    d = hidden // heads

    def split(name):
        y = linear(x, w[p + name + ".weight"], w[p + name + ".bias"], mm)
        return y.view(b, t, heads, d).transpose(1, 2)  # [B, H, T, d]
    q, k, v = split("query"), split("key"), split("value")
    s = mm(q, k.transpose(-1, -2)) * d ** -0.5
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    a = torch.softmax(s, dim=-1)
    o = mm(a, v).transpose(1, 2).reshape(b, t, hidden)
    return linear(o, w[p + "out.weight"], w[p + "out.bias"], mm)


def block(x, w, i, heads, causal, eps, mm):
    p = f"blocks.{i}."
    h = layer_norm(x, w[p + "ln0.weight"], w[p + "ln0.bias"], eps)
    x = x + attention(h, w, p + "attn.", heads, causal, mm)
    h = layer_norm(x, w[p + "ln1.weight"], w[p + "ln1.bias"], eps)
    h = gelu_tanh(linear(h, w[p + "mlp0.weight"], w[p + "mlp0.bias"], mm))
    return x + linear(h, w[p + "mlp1.weight"], w[p + "mlp1.bias"], mm)


def cross_entropy_sum(logits, labels):
    """Sum over positions of ``logsumexp(logits) - logits[label]``."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.unsqueeze(-1)).squeeze(-1)
    return (lse - picked).sum()


# --------------------------------------------------------------------------
# training


def grads_of(w: Dict[str, torch.Tensor], replicas: List[tuple], model,
             mm) -> tuple:
    """The mean loss over every position of every replica's rows and its
    gradient, computed in blocks of rows. ``model`` gives ``loss_sum(w,
    ids, labels, mm)`` and ``positions(ids)``. Returns (loss, {name:
    grad})."""
    for t in w.values():
        t.grad = None
    total = sum(model.positions(ids) for ids, _ in replicas)
    loss = 0.0
    for ids, labels in replicas:
        rows = max(1, BLOCK_TOKENS // ids.shape[1])
        for r in range(0, ids.shape[0], rows):
            part = model.loss_sum(w, ids[r:r + rows], labels[r:r + rows],
                                  mm)
            (part / total).backward()
            loss += float(part.detach()) / total
    return loss, {n: t.grad for n, t in w.items()}


def adamw_(w, grads, state, t, opt):
    """One AdamW update in place (decoupled weight decay, bias-corrected
    moments), as ``torch.optim.AdamW`` defines it."""
    b1, b2 = opt["betas"]
    lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]
    with torch.no_grad():
        for n, p in w.items():
            g = grads[n]
            m, v = state.setdefault(n, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            p.mul_(1 - lr * wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def run_steps(w0: Dict[str, torch.Tensor], steps: List[List[tuple]],
              model, opt: dict, mm=matmul32,
              fault: Optional[str] = None) -> dict:
    """Train the reference from the weights ``w0`` (consumed: updated in
    place) through ``steps``, each a list of every replica's (ids, labels).
    Returns the readings the program is compared on: each step's loss, the
    norm of each leaf's first gradient, and of each leaf's change after the
    last step. ``fault`` plants a fault of the program in the reference put
    in its place: ``half_batch`` (each replica's loss over the first half
    of its rows), ``no_exchange`` (replica 0's gradient alone)."""
    w = {n: t.detach().requires_grad_() for n, t in w0.items()}
    start = {n: t.detach().clone() for n, t in w.items()}
    state: dict = {}
    losses, grad1 = [], None
    for t, replicas in enumerate(steps, start=1):
        if fault == "half_batch":
            replicas = [(i[:i.shape[0] // 2], lab[:lab.shape[0] // 2])
                        for i, lab in replicas]
        elif fault == "no_exchange":
            replicas = replicas[:1]
        loss, grads = grads_of(w, replicas, model, mm)
        losses.append(loss)
        if grad1 is None:
            grad1 = {n: float(g.double().norm()) for n, g in grads.items()}
        adamw_(w, grads, state, t, opt)
    delta = {n: float((w[n].detach() - start[n]).double().norm())
             for n in w}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def gaps(got: dict, want: dict) -> dict:
    """The numbers that decide ``correct``, of readings ``got`` against the
    reference's ``want``: the largest gap of a step's loss (nats), and by
    the worst leaf, the gap between the two norms of the first gradient and
    of the change over the steps, each over the reference's norm of that
    leaf or of the median leaf, whichever is larger. Leaves whose reference
    gradient is under ``ROUNDOFF_GRAD_SHARE`` of the median leaf's are left
    out of the change."""
    loss_gap = max(abs(a - b) for a, b in zip(got["losses"],
                                               want["losses"]))
    g_med = statistics.median(want["grad1"].values())
    grad_gap = max(abs(got["grad1"][n] - g) / max(g, g_med)
                   for n, g in want["grad1"].items())
    moved = [n for n, g in want["grad1"].items()
             if g >= ROUNDOFF_GRAD_SHARE * g_med]
    d_med = statistics.median(want["delta"][n] for n in moved)
    delta_gap = max(abs(got["delta"][n] - want["delta"][n]) /
                    max(want["delta"][n], d_med) for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "delta_gap": delta_gap}
