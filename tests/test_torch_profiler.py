"""The port's profiler against the reference's: the analytic FLOPs models
and the MFU arithmetic equal, the peak table (the H100 SXM at 989, the
PCIe and NVL cards not), the FlopCounterMode count of a matmul and of a
tiny GPT step against a hand count with the flash kernels' share counted
explicitly, the fallback contract, and the reference's ``hvd_*`` span
names in a ``torch.profiler`` trace of world-1 collectives and eager
ops."""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.profiler import flops as ref_flops
from horovod_tpu.profiler import mfu as ref_mfu
from horovod_tpu_torch.profiler import flops, mfu


def test_analytic_models_equal_reference():
    for name in ("RESNET50_FWD_FLOPS_PER_IMAGE", "RESNET50_PARAMS",
                 "BERT_BASE_PARAMS"):
        assert getattr(flops, name) == getattr(ref_flops, name)
    for train in (True, False):
        assert flops.resnet50_train_flops_per_image(train) == \
            ref_flops.resnet50_train_flops_per_image(train)
        for params, seq in ((110e6, 128), (124e6, 1024), (334e6, 512)):
            assert flops.transformer_train_flops_per_seq(
                params, seq, train) == \
                ref_flops.transformer_train_flops_per_seq(params, seq, train)
    args = (8, 56, 56, 64, 256, 1, 1)
    assert flops.conv2d_flops(*args) == ref_flops.conv2d_flops(*args)
    assert flops.dense_flops(8, 768, 3072) == \
        ref_flops.dense_flops(8, 768, 3072)


@pytest.mark.parametrize("items,per_item,peak", [
    (100.0, 1e9, 1.0), (148503.0, 7.5e8, 989.0), (879.0, 2.4e10, 989.0),
    (0.0, 1e9, 100.0), (10.0, -1.0, 100.0), (10.0, 1e9, -1.0)])
def test_mfu_arithmetic_equals_reference(items, per_item, peak):
    assert mfu.mfu(items, per_item, peak) == \
        ref_mfu.mfu(items, per_item, peak)
    est = flops.FlopsEstimate(per_item, "analytic", "hand")
    ref_est = ref_flops.FlopsEstimate(per_item, "analytic", "hand")
    assert mfu.mfu_report(items, est, peak) == \
        ref_mfu.mfu_report(items, ref_est, peak)


def test_peak_table():
    for kind, peak in ref_mfu.PEAK_TFLOPS_BF16.items():
        assert mfu.PEAK_TFLOPS_BF16[kind] == peak
        assert mfu.peak_tflops(kind) == ref_mfu.peak_tflops(kind)
    assert mfu.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    # the PCIe (756 TFLOP/s) and NVL cards must not get the SXM peak
    for kind in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA H100",
                 "NVIDIA H100 80GB", "GPU A100"):
        assert mfu.peak_tflops(kind) != 989.0, kind
        assert mfu.peak_tflops(kind) == -1.0, kind


def test_default_peak_comes_from_the_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mfu.peak_tflops() == -1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert mfu.peak_tflops() == 989.0


def test_counted_matmul_and_its_gradient():
    m, k, n = 128, 256, 64
    a, b = torch.ones(m, k), torch.ones(k, n, requires_grad=True)
    assert flops.compiled_flops(lambda: a @ b) == flops.dense_flops(m, k, n)

    def step():
        (a @ b).sum().backward()
    est = flops.train_step_flops(step, ())
    assert est.source == "torch_flop_counter"
    # the forward and dW = A^T dY (A needs no gradient)
    assert est.flops == 2 * flops.dense_flops(m, k, n)


def test_fallback_when_nothing_is_counted():
    est = flops.train_step_flops(lambda: None, (), fallback_flops=123.0,
                                 fallback_detail="hand model")
    assert (est.source, est.flops, bool(est)) == ("analytic", 123.0, True)
    est = flops.train_step_flops(lambda: None, ())
    assert est.source == "unavailable" and not bool(est)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_pairs(causal):
    for tq, tk, q_off, k_off in ((64, 64, 0, 0), (32, 64, 32, 0),
                                 (16, 16, 0, 48), (16, 16, 48, 0)):
        i = np.arange(tq)[:, None] + q_off
        j = np.arange(tk)[None, :] + k_off
        want = int((j <= i).sum()) if causal else tq * tk
        assert flops.attention_pairs(tq, tk, causal, q_off, k_off) == want


def test_tiny_gpt_step_against_hand_count(monkeypatch):
    """One forward and backward of a tiny GPT on the flash path: every
    Dense and the tied LM head three times their forward product, plus the
    flash kernels' 12 * D FLOPs per causally visible pair. On the CPU the
    plain versions' einsums run inside the launches and are not counted
    again."""
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", "16")
    cfg = dict(vocab=64, layers=2, hidden=32, heads=2, mlp_dim=128,
               max_len=64)
    model = GptDecoder(dtype=torch.float32, **cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    b, t = 2, 64
    tokens = torch.randint(0, cfg["vocab"], (b, t),
                           generator=torch.Generator().manual_seed(1))

    def step():
        lm_loss(model, tokens)[0].backward()
    est = flops.train_step_flops(step, ())
    tok, hid, mlp = b * t, cfg["hidden"], cfg["mlp_dim"]
    dense = 4 * flops.dense_flops(tok, hid, hid) + \
        flops.dense_flops(tok, hid, mlp) + flops.dense_flops(tok, mlp, hid)
    head = flops.dense_flops(tok, hid, cfg["vocab"])
    d = hid // cfg["heads"]
    attn = 12 * d * b * cfg["heads"] * (t * (t + 1) // 2)
    want = 3 * (cfg["layers"] * dense + head) + cfg["layers"] * attn
    assert est.source == "torch_flop_counter"
    assert est.flops == want
    assert "flash kernels" in est.detail and "flash_bwd_dkv" in est.detail


def test_collective_scopes_in_a_profiler_trace():
    """The reference's names (collectives.py:93-319) on world-1
    collectives, and the eager ops' host spans (reference eager.py:139,
    :534)."""
    from horovod_tpu_torch.parallel import collectives as c
    hvd.init(device="cpu")
    try:
        x = torch.arange(8.0)
        with torch.profiler.profile() as prof:
            c.allreduce(x, op=c.Sum)
            c.allreduce(x)
            c.allreduce(x, op=c.Max, axis="model")
            c.hierarchical_allreduce(x)
            c.allgather(x)
            c.alltoall(x, axis="seq")
            c.reducescatter(x, op=c.Sum)
            c.broadcast(x, 0)
            c.quantized_allreduce(x)
            hvd.synchronize(hvd.allreduce_async(x, name="eager_x"))
        names = {e.name for e in prof.events()}
    finally:
        hvd.shutdown()
    for want in ("hvd_allreduce_sum", "hvd_allreduce_average",
                 "hvd_allreduce_max", "hvd_hierarchical_allreduce_average",
                 "hvd_allgather", "hvd_alltoall", "hvd_reducescatter_sum",
                 "hvd_broadcast", "hvd_quantized_reducescatter_average",
                 "hvd_quantized_allgather", "hvd_enqueue:eager_x",
                 "hvd_negotiate_wait:eager_x"):
        assert want in names, want
