"""The ctypes signatures of the port's CUDA entry points against their C
declarations.

``_build.SIGNATURES`` tells ctypes how to pass each argument of the
``extern "C"`` functions in ``horovod_tpu_torch/ops/csrc/*.cu``. A mismatch
(an argument added on one side only, an int passed where the C side reads a
float) cuts or shifts arguments silently on the card, and no CPU test runs
those functions. This file parses the C declarations and checks the count
and the kind (pointer, int, float) of every argument, position by position.
"""

import ctypes
import re

import pytest

from horovod_tpu_torch.ops import _build

_DECL = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)
_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def _c_kind(param: str) -> str:
    p = " ".join(param.split())
    if "*" in p:
        return "pointer"
    words = p.replace("const ", "").split()
    if words[0] in ("int", "float"):
        return words[0]
    raise AssertionError(f"unexpected C parameter type: {param!r}")


def _declarations():
    """symbol -> (source file, return type, [kind of each parameter])."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in _DECL.findall(path.read_text()):
            kinds = [_c_kind(p) for p in params.split(",") if p.strip()]
            found[name] = (path.name, ret, kinds)
    return found


def test_every_entry_point_has_a_signature_and_back():
    decls = _declarations()
    assert decls, "no extern \"C\" entry points found"
    assert set(decls) == set(_build.SIGNATURES)


@pytest.mark.parametrize("symbol", sorted(_build.SIGNATURES))
def test_signature_matches_c_declaration(symbol):
    src, ret, kinds = _declarations()[symbol]
    lib, argtypes = _build.SIGNATURES[symbol]
    assert src == _build.SOURCES[lib], f"{symbol} lives in {src}"
    assert ret == "int", "every entry point returns its cudaError_t as int"
    want = [_KIND[t] for t in argtypes]
    assert len(kinds) == len(want), (symbol, kinds, want)
    for i, (c, py) in enumerate(zip(kinds, want)):
        assert c == py, f"{symbol} argument {i}: C {c}, ctypes {py}"


# the entry points that launch a kernel, one per wrapper in fa.KERNELS
LAUNCHERS = ["hvd_flash_fwd", "hvd_flash_bwd_dq", "hvd_flash_bwd_dkv"]


def test_launchers_are_the_wrappers():
    from horovod_tpu_torch.ops import flash_attention as fa
    assert ["hvd_" + k.__name__ for k in fa.KERNELS] == LAUNCHERS


@pytest.mark.parametrize("symbol", LAUNCHERS)
def test_stream_is_the_last_argument(symbol):
    # the wrapper appends the stream after the kernel's own arguments
    assert _build.SIGNATURES[symbol][1][-1] is ctypes.c_void_p
    assert _declarations()[symbol][2][-1] == "pointer"


def test_parser_sees_the_kinds():
    assert _c_kind("const void* q") == "pointer"
    assert _c_kind("int block_k") == "int"
    assert _c_kind("int* info") == "pointer"
    assert _c_kind(" float\n scale") == "float"
    with pytest.raises(AssertionError):
        _c_kind("double x")


@pytest.mark.parametrize("symbol", LAUNCHERS)
def test_wrapper_passes_as_many_arguments(symbol):
    """The Python wrapper's launch call gives the C function all but the
    stream, which ``_launch`` appends."""
    import inspect
    from horovod_tpu_torch.ops import flash_attention as fa
    src = inspect.getsource(fa)
    m = re.search(r'_launch\("%s",\s*"\w+",(.*?)\)\n' % symbol, src, re.S)
    assert m, f"no _launch call for {symbol}"
    # arguments after the device: split on top-level commas
    args, depth, cur = [], 0, ""
    for ch in m.group(1):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    args.append(cur.strip())
    args = [a for a in args if a][1:]  # drop the device
    assert len(args) == len(_build.SIGNATURES[symbol][1]) - 1


@pytest.mark.parametrize("name,dtype,head_dim", [
    ("flash_fwd", "float16", 64), ("flash_bwd_dkv", "bfloat16", 48),
    ("flash_bwd", "bfloat16", 64)])
def test_kernel_info_rejects_what_has_no_kernel(name, dtype, head_dim):
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    with pytest.raises(ValueError):
        fa.kernel_info(name, getattr(torch, dtype), head_dim)


@pytest.mark.parametrize("tq,tk,bq,bk,want", [
    (1024, 1024, 512, 512, (512, 512)),   # the reference's own tiling
    (128, 256, 128, 128, (128, 128)),
    (200, 200, 512, 512, (0, 0)),         # blocks longer than the sequence
    (192, 192, 128, 64, (0, 0)),          # block_q does not divide Tq
    (192, 192, 64, 0, (0, 0))])
def test_forward_gets_the_reference_tiling_only_when_blocks_tile(
        tq, tk, bq, bk, want):
    from horovod_tpu_torch.ops import flash_attention as fa
    assert fa._reference_tiling(tq, tk, bq, bk) == want
