"""On the card: each CUDA flash kernel against its plain PyTorch version on
the same card tensors, the wrappers' input checks, and the launch counters
of a GPT step. Imports torch and the port only (no JAX), so it also runs on
a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Every test skips where no CUDA device is present. Tolerances: fp32 as the
reference's tests (rtol 2e-4 / atol 2e-5 forward, 2e-3 / 2e-4 gradients);
bf16 a few bf16 ulps, since the kernels tile by 64 (or 32) rows and the
plain version by the block arguments."""

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
    _check_against_plain(q, k, v, do,
                         (causal, head_dim ** -0.5, 0.0, 0.0, 64, 64))


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
    not write, and no result depends on block scheduling. The last two
    cases are the main path's head width and length in bf16, the second
    with rows that see no key under 512-row reference tiles."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128):
            cases.append(((True, d ** -0.5),
                          _inputs(cuda_device, dt, 2, 200, 200, 3, d, d)))
    for q_off in (0.0, -10.0):
        cases.append(((True, 0.125, q_off, 0.0, 512, 512),
                      _inputs(cuda_device, torch.bfloat16, 2, 1024, 1024, 4,
                              64, 40)))

    def run(args, tensors):
        q, k, v, do = tensors
        o, lse = fa.flash_fwd(q, k, v, *args)
        corr = (-(do.float() * o.float()).sum(-1)).transpose(1, 2) \
            .contiguous()
        return [o, lse, fa.flash_bwd_dq(q, k, v, do, lse, corr, *args),
                *fa.flash_bwd_dkv(q, k, v, do, lse, corr, *args)]

    first = [run(*c) for c in cases]
    junk = torch.randn(2048, 2048, device=cuda_device)
    for _ in range(3):
        for c, want in zip(reversed(cases), reversed(first)):
            junk = junk @ junk.T * 1e-3  # other kernels in between
            for got, ref in zip(run(*c), want):
                assert torch.equal(got, ref)


def _check_against_plain(q, k, v, do, args, dlse=None):
    """Every kernel output against its plain version, o and lse on every
    row (rows with no visible key included)."""
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, *args)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2)
    corr = ((0.0 if dlse is None else dlse) - delta).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, corr, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, corr, *args)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, corr, *args)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, corr, *args)
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=2e-3)
    if q.dtype == torch.float32:
        torch.testing.assert_close(o, o_p, rtol=2e-4, atol=2e-5)
        for a, b in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
            torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)
    else:
        for a, b in ((o, o_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)):
            _assert_bf16_close(a, b)
    return o, lse


# (name, dtype, causal, b, tq, tk, h, d, block_q, block_k, q_off, k_off,
#  dlse)
EDGE_CASES = [
    ("single_tile_64", "bfloat16", True, 2, 64, 64, 2, 64, 64, 64, 0.0, 0.0,
     False),
    ("ragged_200", "bfloat16", True, 2, 200, 200, 3, 64, 200, 200, 0.0, 0.0,
     False),
    ("d128_offsets_tq_ne_tk", "bfloat16", True, 2, 128, 256, 2, 128, 128,
     128, 128.0, 0.0, True),
    ("dead_rows_512_f32", "float32", True, 1, 1024, 1024, 2, 64, 512, 512,
     -10.0, 0.0, False),
    ("dead_rows_512_bf16", "bfloat16", True, 1, 1024, 1024, 2, 64, 512, 512,
     -10.0, 0.0, False),
    # (a dlse cotangent: with one key the gradients come from it alone)
    ("one_row_one_key", "bfloat16", False, 1, 1, 1, 1, 64, 1, 1, 0.0, 0.0,
     True),
    ("ragged_65_100_full_d32", "bfloat16", False, 2, 65, 100, 2, 32, 65,
     100, 0.0, 0.0, True),
    ("ragged_100_300_causal_d128", "bfloat16", True, 1, 100, 300, 2, 128,
     100, 100, 200.0, 0.0, True),
    # one q tile against a long key side: the dq kernel's ring wraps 16 times
    ("one_q_tile_long_k", "bfloat16", False, 2, 64, 1024, 2, 64, 64, 1024,
     0.0, 0.0, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_cuda_kernel_edges_match_plain(cuda_device, case):
    """The TMA/wgmma kernels' edges: one tile (the ring never fills),
    ragged lengths (TMA zero fill) down to one row and one key, Tq != Tk
    with offsets at d=128, rows with no visible key under 512-row
    reference tiles, and one q tile against 1024 keys."""
    _, dtype, causal, b, tq, tk, h, d, bq, bk, q_off, k_off, with_dlse = \
        case
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(tq + d)
    q = torch.randn(b, tq, h, d, generator=g).to(cuda_device, dt)
    k, v = (torch.randn(b, tk, h, d, generator=g).to(cuda_device, dt)
            for _ in range(2))
    do = torch.randn(b, tq, h, d, generator=g).to(cuda_device, dt)
    dlse = torch.randn(b, h, tq, generator=g).to(cuda_device) \
        if with_dlse else None
    _check_against_plain(q, k, v, do,
                         (causal, d ** -0.5, q_off, k_off, bq, bk), dlse)


@pytest.mark.cuda
def test_cuda_dead_rows_take_the_mean_over_reference_tiles(cuda_device):
    """With q_offset = -10 and 512-row tiles, rows 0-9 see no key; the
    reference's first q block visits keys [0, 512), so their o is the mean
    of v over those keys and their lse is NEG_INF."""
    g = torch.Generator().manual_seed(21)
    q, k, v = (torch.randn(1, 1024, 2, 64, generator=g).to(cuda_device)
               for _ in range(3))
    o, lse = fa.flash_fwd(q, k, v, True, 0.125, -10.0, 0.0, 512, 512)
    torch.cuda.synchronize()
    want = v[:, :512].mean(1, keepdim=True).expand(1, 10, 2, 64)
    torch.testing.assert_close(o[:, :10], want, rtol=2e-4, atol=2e-5)
    assert bool((lse[:, :, :10] == fa.NEG_INF).all())
    assert bool((lse[:, :, 10:] > fa.NEG_INF / 2).all())


@pytest.mark.cuda
def test_cuda_redesigned_kernels_keep_accumulators_in_registers(cuda_device):
    """The bf16 TMA/wgmma kernels do not spill and keep at least two blocks
    resident per SM at every head width."""
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for d in (32, 64, 128):
            info = fa.kernel_info(name, torch.bfloat16, d)
            assert info["local_bytes"] == 0, (name, d, info)
            assert info["blocks_per_sm"] >= 2, (name, d, info)


@pytest.mark.cuda
def test_step_flops_equal_on_cpu_and_card(cuda_device, monkeypatch):
    """One forward and backward of a tiny GPT on the flash path counts the
    same FLOPs on the card (ctypes launches, invisible to
    FlopCounterMode) as on the CPU (the plain versions' einsums, taken
    out again): the flash share is counted from the visible pairs."""
    from horovod_tpu_torch.models.gpt import GptDecoder, lm_loss
    from horovod_tpu_torch.profiler import flops
    monkeypatch.setenv("HOROVOD_FLASH_MIN_SEQ", "16")
    cfg = dict(vocab=64, layers=2, hidden=64, heads=2, mlp_dim=128,
               max_len=128, dtype=torch.float32)
    tokens = torch.randint(0, 64, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    counts = []
    for dev in (torch.device("cpu"), cuda_device):
        model = GptDecoder(**cfg).to(dev)
        batch = tokens.to(dev)

        def step():
            lm_loss(model, batch)[0].backward()
        counts.append(flops.train_step_flops(step, ()))
    assert counts[0].flops == counts[1].flops > 0
    assert counts[0].detail == counts[1].detail
