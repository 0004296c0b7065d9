"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``. Builds start together and run in
parallel. The library name carries a digest of the sources and flags, so an
edited source rebuilds and an unchanged one is loaded from the build
directory (``build/horovod_tpu_torch/`` at the repository root, which
``.gitignore`` lists). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
HEADERS = ("flash_common.cuh", "flash_sm90.cuh")
# library name -> its one source file
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (library, argtypes); every pointer and the stream are
# c_void_p, every C function returns its cudaError_t as an int.
SIGNATURES = {
    "hvd_flash_fwd": ("flash_fwd", [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _F, _F, _F, _I, _I, _P]),
    "hvd_flash_bwd_dq": ("flash_bwd", [_I, _I, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _F, _F, _F, _P]),
    "hvd_flash_bwd_dkv": ("flash_bwd", [_I, _I, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _I, _I, _I, _I, _I, _F, _F, _F,
                                        _P]),
    # kernel attributes: (dtype, head_dim[, which], int[4] out)
    "hvd_flash_fwd_info": ("flash_fwd", [_I, _I, _P]),
    "hvd_flash_bwd_info": ("flash_bwd", [_I, _I, _I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "horovod_tpu_torch are built on a machine with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Build the named libraries that are not built yet, all nvcc processes
    at once. Returns seconds per library built; raises with the compiler's
    output if any build fails. The compiler's log (with ``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside each
    library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc {SOURCES[name]} failed "
                            f"({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler output kept from the build of library ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def function(symbol: str):
    """The C entry point ``symbol``, building and loading its library at
    first use."""
    lib_name = SIGNATURES[symbol][0]
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            build([lib_name])
            lib = ctypes.CDLL(str(library_path(lib_name)))
            for sym, (owner, types) in SIGNATURES.items():
                if owner == lib_name:
                    fn = getattr(lib, sym)
                    fn.argtypes = types
                    fn.restype = ctypes.c_int
            _libs[lib_name] = lib
    return getattr(lib, symbol)
