"""The port stands alone: importing it loads no JAX, flax, optax or
horovod_tpu module, its sources import none of them, and its entry points
refuse to run without CUDA unless the caller asks for the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import horovod_tpu_torch as hvd

PKG = Path(hvd.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_or_reference_module():
    code = (
        "import json, sys\n"
        "import horovod_tpu_torch, horovod_tpu_torch.parallel.dp, "
        "horovod_tpu_torch.models.convert, horovod_tpu_torch.models.gpt, "
        "horovod_tpu_torch.models.resnet, horovod_tpu_torch.models.mnist, "
        "horovod_tpu_torch.sync_batch_norm, horovod_tpu_torch.ops._build, "
        "horovod_tpu_torch.common.eager, horovod_tpu_torch.mpi_ops, "
        "horovod_tpu_torch.functions, horovod_tpu_torch.optimizer, "
        "horovod_tpu_torch.parallel.sp, horovod_tpu_torch.parallel.tp, "
        "horovod_tpu_torch.parallel.pp, horovod_tpu_torch.parallel.ep, "
        "horovod_tpu_torch.profiler, horovod_tpu_torch.profiler.flops, "
        "horovod_tpu_torch.profiler.mfu, "
        "horovod_tpu_torch.profiler.annotate, horovod_tpu_torch.elastic, "
        "horovod_tpu_torch.common.exceptions, "
        "horovod_tpu_torch.common.kv_keys, horovod_tpu_torch.metrics, "
        "horovod_tpu_torch.metrics.registry, horovod_tpu_torch.runner, "
        "horovod_tpu_torch.runner.http_kv, "
        "horovod_tpu_torch.runner.elastic.worker, "
        "horovod_tpu_torch.runner.elastic.headless, "
        "horovod_tpu_torch.runner.elastic.preempt, "
        "horovod_tpu_torch.runner.elastic.registration, "
        "horovod_tpu_torch.common.journal, horovod_tpu_torch.obs.tracing, "
        "horovod_tpu_torch.profiler.trace_merge, horovod_tpu_torch.serve, "
        "horovod_tpu_torch.serve.worker, horovod_tpu_torch.serve.loadgen\n"
        "from horovod_tpu_torch.parallel import ring_attention, "
        "ulysses_attention\n"
        "from horovod_tpu_torch.profiler import mfu_report, "
        "train_step_flops, collective_scope, merge_traces\n"
        "from horovod_tpu_torch.serve import (ServingLoop, make_tp_lm_step, "
        "make_rnn_lm_step, ServeFrontend, RequestRouter, PagedKVCache)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=PKG.parent, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "horovod_tpu_torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


ELASTIC_SOURCES = ("elastic.py", "common/exceptions.py", "common/kv_keys.py",
                   "metrics/__init__.py", "metrics/registry.py",
                   "runner/__init__.py", "runner/http_kv.py",
                   "runner/elastic/__init__.py", "runner/elastic/worker.py",
                   "runner/elastic/headless.py", "runner/elastic/preempt.py",
                   "runner/elastic/registration.py")
SERVE_SOURCES = ("common/journal.py", "obs/__init__.py", "obs/tracing.py",
                 "profiler/trace_merge.py", "serve/__init__.py",
                 "serve/admission.py", "serve/batcher.py",
                 "serve/executor.py", "serve/frontend.py",
                 "serve/kv_cache.py", "serve/loadgen.py", "serve/router.py",
                 "serve/worker.py")


def test_sources_import_no_jax_or_reference_module():
    """The package's sources (the elastic and serving slices' modules
    among them) and the two chip scripts beside it."""
    offenders = []
    scripts = [PKG.parent / "chip_smoke.py", PKG.parent / "compare_trees.py"]
    sources = sorted(PKG.rglob("*.py"))
    assert {str(p.relative_to(PKG)) for p in sources} >= \
        set(ELASTIC_SOURCES + SERVE_SOURCES)
    for path in sources + scripts:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [f"{path.name}: {n}" for n in names
                          if _forbidden(n)]
    assert offenders == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_init_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


def test_serving_entry_points_raise_without_cuda(no_cuda):
    from horovod_tpu_torch.serve import make_rnn_lm_step, make_tp_lm_step
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_rnn_lm_step()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tp_lm_step(axis=None)


def test_make_train_step_without_device_raises_without_cuda(no_cuda):
    from horovod_tpu_torch.models.gpt import lm_loss
    from horovod_tpu_torch.parallel import dp
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp.make_train_step(model, lm_loss, opt)


def test_cpu_init_reports_topology():
    hvd.init(device="cpu")
    try:
        assert hvd.is_initialized()
        assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (0, 1, 0)
        assert hvd.device() == torch.device("cpu")
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="init"):
        hvd.rank()


def test_reduce_ops_and_compression_mirror_reference():
    from horovod_tpu.common import reduce_ops as ref_ops
    from horovod_tpu_torch.common import reduce_ops
    assert [o.value for o in reduce_ops.Op] == [o.value for o in ref_ops.Op]
    x = torch.tensor([1.5, -2.25], dtype=torch.float32)
    for name, wire in (("fp16", torch.float16), ("bf16", torch.bfloat16)):
        comp = getattr(hvd.Compression, name)
        y, ctx = comp.compress(x)
        assert y.dtype == wire and comp.decompress(y, ctx).dtype == x.dtype
    i = torch.tensor([3])
    assert hvd.Compression.bf16.compress(i)[0].dtype == torch.int64
    assert hvd.Compression.none.compress(x)[0] is x


def test_env_contract(monkeypatch):
    from horovod_tpu_torch.common.env import env_int
    monkeypatch.setenv("HOROVOD_SIZE", "")
    assert env_int("HOROVOD_SIZE") == 1
    monkeypatch.setenv("HOROVOD_RANK", "3")
    assert env_int("HOROVOD_RANK") == 3
    with pytest.raises(KeyError):
        env_int("HOROVOD_NOT_A_VARIABLE")


def test_kernel_build_is_lazy_and_names_its_sources():
    """Importing the ops builds nothing; the build targets name the repo's
    CUDA sources and Hopper's sm_90a."""
    from horovod_tpu_torch.ops import _build
    assert _build._libs == {}
    for src in _build.SOURCES.values():
        assert (_build.CSRC / src).exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path("flash_fwd").parent == _build.BUILD_DIR
