"""The port stands alone: importing it loads no JAX, flax, optax or
horovod_tpu module, its sources import none of them (nor cloudpickle or
ray at module level), and its entry points refuse to run without CUDA
unless the caller asks for the CPU."""

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


# imported inside the functions that need them, never by a module: the
# card's machine has neither
LAZY_ONLY = ("cloudpickle", "ray")


def _lazy_only(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in LAZY_ONLY)


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
        "horovod_tpu_torch.serve.worker, horovod_tpu_torch.serve.loadgen, "
        "horovod_tpu_torch.common.hvd_logging, "
        "horovod_tpu_torch.runner.hosts, horovod_tpu_torch.runner.exec_utils, "
        "horovod_tpu_torch.runner.launch, horovod_tpu_torch.metrics.prom, "
        "horovod_tpu_torch.metrics.exporter, "
        "horovod_tpu_torch.metrics.straggler, "
        "horovod_tpu_torch.metrics.aggregator, "
        "horovod_tpu_torch.runner.elastic.discovery, "
        "horovod_tpu_torch.runner.elastic.driver, "
        "horovod_tpu_torch.runner.elastic.supervisor, "
        "horovod_tpu_torch.runner.elastic.autoscaler, "
        "horovod_tpu_torch.serve.autoscale_smoke, "
        "horovod_tpu_torch.examples.gpt_train, "
        "horovod_tpu_torch.examples.elastic_train, "
        "horovod_tpu_torch.common.flight_recorder, "
        "horovod_tpu_torch.profiler.flight, horovod_tpu_torch.obs, "
        "horovod_tpu_torch.obs.attribution, horovod_tpu_torch.obs.doctor, "
        "horovod_tpu_torch.obs.top, horovod_tpu_torch.verify, "
        "horovod_tpu_torch.verify.conformance, "
        "horovod_tpu_torch.common.response_cache, "
        "horovod_tpu_torch.common.stall_inspector, "
        "horovod_tpu_torch.common.timeline, "
        "horovod_tpu_torch.common.parameter_manager, "
        "horovod_tpu_torch.tune, horovod_tpu_torch.tune.space, "
        "horovod_tpu_torch.tune.search, horovod_tpu_torch.tune.tuner, "
        "horovod_tpu_torch.tune.smoke, horovod_tpu_torch.verify.rules, "
        "horovod_tpu_torch.runner.replica_kv, "
        "horovod_tpu_torch.runner.run_task, "
        "horovod_tpu_torch.runner.cluster_job, horovod_tpu_torch.ray, "
        "horovod_tpu_torch.examples.mnist, "
        "horovod_tpu_torch.examples.synthetic_benchmark, "
        "horovod_tpu_torch.examples.long_context_attention, "
        "horovod_tpu_torch.examples.serve, "
        "horovod_tpu_torch.examples.merged_trace, "
        "horovod_tpu_torch.lint, horovod_tpu_torch.lint.base, "
        "horovod_tpu_torch.lint.cli, horovod_tpu_torch.lint.py_collectives, "
        "horovod_tpu_torch.lint.py_env, horovod_tpu_torch.lint.py_kv, "
        "horovod_tpu_torch.verify.spec, horovod_tpu_torch.verify.checker, "
        "horovod_tpu_torch.verify.specs, horovod_tpu_torch.verify.cli, "
        "horovod_tpu_torch.verify.engine_constants\n"
        "from horovod_tpu_torch import run\n"
        "from horovod_tpu_torch.parallel import ring_attention, "
        "ulysses_attention\n"
        "from horovod_tpu_torch.profiler import mfu_report, "
        "train_step_flops, collective_scope, merge_traces\n"
        "from horovod_tpu_torch.serve import (ServingLoop, make_tp_lm_step, "
        "make_rnn_lm_step, ServeFrontend, RequestRouter, PagedKVCache)\n"
        "import torch\n"
        "print(json.dumps([torch.cuda.is_initialized(), "
        "sorted(sys.modules)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=PKG.parent, check=True)
    cuda, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "horovod_tpu_torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert [m for m in loaded if _lazy_only(m)] == []
    assert not cuda  # importing touches no device


ELASTIC_SOURCES = ("elastic.py", "common/exceptions.py", "common/kv_keys.py",
                   "metrics/__init__.py", "metrics/registry.py",
                   "runner/__init__.py", "runner/http_kv.py",
                   "runner/elastic/__init__.py", "runner/elastic/worker.py",
                   "runner/elastic/headless.py", "runner/elastic/preempt.py",
                   "runner/elastic/registration.py")
LAUNCH_SOURCES = ("common/hvd_logging.py", "runner/hosts.py",
                  "runner/exec_utils.py", "runner/launch.py",
                  "metrics/prom.py", "metrics/exporter.py",
                  "metrics/straggler.py", "metrics/aggregator.py",
                  "runner/elastic/discovery.py", "runner/elastic/driver.py",
                  "runner/elastic/supervisor.py",
                  "runner/elastic/autoscaler.py",
                  "serve/autoscale_smoke.py", "examples/__init__.py",
                  "examples/gpt_train.py", "examples/elastic_train.py")
SERVE_SOURCES = ("common/journal.py", "obs/__init__.py", "obs/tracing.py",
                 "profiler/trace_merge.py", "serve/__init__.py",
                 "serve/admission.py", "serve/batcher.py",
                 "serve/executor.py", "serve/frontend.py",
                 "serve/kv_cache.py", "serve/loadgen.py", "serve/router.py",
                 "serve/worker.py")
OBS_SOURCES = ("common/flight_recorder.py", "profiler/flight.py",
               "obs/attribution.py", "obs/doctor.py", "obs/top.py",
               "verify/__init__.py", "verify/conformance.py")
RUN_SOURCES = ("verify/rules.py", "runner/replica_kv.py",
               "runner/run_task.py", "runner/cluster_job.py",
               "ray/__init__.py", "examples/mnist.py",
               "examples/synthetic_benchmark.py",
               "examples/long_context_attention.py", "examples/serve.py",
               "examples/merged_trace.py")
CHECK_SOURCES = ("lint/__init__.py", "lint/__main__.py", "lint/base.py",
                 "lint/cli.py", "lint/py_collectives.py", "lint/py_env.py",
                 "lint/py_kv.py", "verify/__main__.py", "verify/spec.py",
                 "verify/checker.py", "verify/specs.py", "verify/cli.py",
                 "verify/engine_constants.py")


def test_sources_import_no_jax_or_reference_module():
    """The package's sources (the elastic, serving, launcher, post-mortem
    and static-check slices' modules among them) and the two chip scripts
    beside it."""
    offenders = []
    scripts = [PKG.parent / "chip_smoke.py", PKG.parent / "compare_trees.py"]
    sources = sorted(PKG.rglob("*.py"))
    assert {str(p.relative_to(PKG)) for p in sources} >= \
        set(ELASTIC_SOURCES + SERVE_SOURCES + LAUNCH_SOURCES + OBS_SOURCES +
            RUN_SOURCES + CHECK_SOURCES)
    for path in sources + scripts:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            offenders += [f"{path.name}: {n}" for n in _imported(node)
                          if _forbidden(n)]
        # module level: the statements of the module body, outside any
        # function (a guarded top-level import counts too)
        top = [n for stmt in tree.body if not isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            for n in ast.walk(stmt)]
        top += [n for cls in tree.body if isinstance(cls, ast.ClassDef)
                for stmt in cls.body if not isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                for n in ast.walk(stmt)]
        offenders += [f"{path.name}: module-level {n}" for node in top
                      for n in _imported(node) if _lazy_only(n)]
    assert offenders == []


def _imported(node) -> list:
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.module:
        return [node.module]
    return []


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
