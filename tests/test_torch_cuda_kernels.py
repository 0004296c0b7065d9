"""On the card: each CUDA flash kernel against its plain PyTorch version on
the same card tensors, the wrappers' input checks, and the launch counters
of a GPT step. Imports torch and the port only (no JAX), so it also runs on
a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Every test skips where no CUDA device is present. Tolerances: fp32 as the
reference's tests (rtol 2e-4 / atol 2e-5 forward, 2e-3 / 2e-4 gradients);
bf16 a few bf16 ulps, since the kernel tiles by 64 and the plain version by
the block arguments."""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, b, tq, tk, h, d, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g).to(device, dtype)
            for t in (tq, tk, tk, tq)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernels_match_plain(cuda_device, dtype, head_dim, causal):
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(cuda_device, dt, 2, 192, 192, 3, head_dim,
                          head_dim)
    args = (causal, head_dim ** -0.5, 0.0, 0.0, 64, 64)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, *args)
    corr = (-(do.float() * o_p.float()).sum(-1)).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, corr, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, corr, *args)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, corr, *args)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, corr, *args)
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=2e-3)
    if dt == torch.float32:
        torch.testing.assert_close(o, o_p, rtol=2e-4, atol=2e-5)
        for a, b in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
            torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)
    else:
        for a, b in ((o, o_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)):
            _assert_bf16_close(a, b)


def _assert_bf16_close(got, want):
    """A few bf16 ulps of each element or of the largest element in its row
    (one query's output, one key's gradient), and about one ulp in norm."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    row_max = want.abs().amax(-1, keepdim=True)
    assert bool((err <= 1e-6 + 2e-2 * row_max + 2e-2 * want.abs()).all()), \
        float(err.max())
    assert float((got - want).norm() / want.norm()) <= 1e-2


@pytest.mark.cuda
def test_cuda_flash_attention_autograd_matches_cpu(cuda_device):
    """flash_attention end to end with offsets, Tq != Tk and a dlse
    cotangent: the card's kernels against the CPU's plain versions."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 64, 2, 64, generator=g)
    k, v = (torch.randn(2, 128, 2, 64, generator=g) for _ in range(2))
    do = torch.randn(2, 64, 2, 64, generator=g)
    dl = torch.randn(2, 2, 64, generator=g)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        ts = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        o, lse = fa.flash_attention(*ts, causal=True, q_offset=64.0,
                                    return_lse=True)
        ((o * do.to(dev)).sum() + (lse * dl.to(dev)).sum()).backward()
        outs.append([x.detach().cpu() for x in (o, lse)] +
                    [t.grad.cpu() for t in ts])
    for i, (a, b) in enumerate(zip(*outs)):
        tol = dict(rtol=2e-4, atol=2e-5) if i < 2 else \
            dict(rtol=2e-3, atol=2e-4)
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
def test_cuda_wrappers_reject_unsupported_inputs(cuda_device):
    q = torch.zeros(1, 64, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q, q, q, False, 0.125)
    q = torch.zeros(1, 64, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, False, 0.125)
    q = torch.zeros(1, 2, 64, 64, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, q, q, False, 0.125)


@pytest.mark.cuda
def test_cuda_gpt_step_launches_each_kernel_once_per_layer(cuda_device):
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    model = GptDecoder(vocab=256, layers=3, hidden=128, heads=2,
                       mlp_dim=256, max_len=1024)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(cuda_device)
    tokens = torch.randint(0, 256, (2, 1024), device=cuda_device)
    fa.reset_launch_counts()
    loss, _ = lm_loss(model, tokens)
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fa.launch_counts() == {"flash_fwd": 3, "flash_bwd_dq": 3,
                                  "flash_bwd_dkv": 3}


@pytest.mark.cuda
def test_cuda_kernels_are_bitwise_repeatable(cuda_device):
    """Each kernel gives bit-identical results when it runs again after
    other kernels have used the card: no block reads shared memory it did
    not write, and no result depends on block scheduling."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128):
            cases.append((d, _inputs(cuda_device, dt, 2, 200, 200, 3, d, d)))

    def run(d, tensors):
        q, k, v, do = tensors
        o, lse = fa.flash_fwd(q, k, v, True, d ** -0.5)
        corr = (-(do.float() * o.float()).sum(-1)).transpose(1, 2) \
            .contiguous()
        return [o, lse, fa.flash_bwd_dq(q, k, v, do, lse, corr, True,
                                        d ** -0.5),
                *fa.flash_bwd_dkv(q, k, v, do, lse, corr, True, d ** -0.5)]

    first = [run(*c) for c in cases]
    junk = torch.randn(2048, 2048, device=cuda_device)
    for _ in range(3):
        for c, want in zip(reversed(cases), reversed(first)):
            junk = junk @ junk.T * 1e-3  # other kernels in between
            for got, ref in zip(run(*c), want):
                assert torch.equal(got, ref)
