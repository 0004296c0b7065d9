"""Kernel-ABI drift rule (HVL104) over the port's CUDA kernels.

Counterpart of ``horovod_tpu/lint/abi_rules.py``, which reads the engine's
C ABI (``engine/src/c_api.cc``) against its ctypes bindings. The port's C
ABI is its kernels': the ``extern "C" int hvd_*`` entry points of
``ops/csrc/*.cu``, bound by ctypes through ``ops/_build.py``'s
``SIGNATURES`` (symbol -> library, argtypes) and ``SOURCES`` (library ->
its one source file), with the dtype codes and instantiated head widths
written twice: ``_KERNEL_DTYPES``, ``_KERNEL_HEAD_DIMS`` and the wide
instantiation's head_dim code ``_KERNEL_WIDE`` in
``ops/flash_attention.py``, and the ``HVD_FLASH_CASE`` and
``HVD_FLASH_WIDE_CASE`` lines of ``HVD_FLASH_DISPATCH`` (the latter at
``#define HVD_FLASH_WIDE``'s code) in ``csrc/flash_common.cuh``. A drift
between the
two sides shows only on the card, as a cudaErrorInvalidValue or an
argument cut or shifted by ctypes. HVL104 reads both sides (a regex for
the C side, ``ast`` for the Python side) and flags:

- an exported ``hvd_*`` function that ``SIGNATURES`` does not bind under
  the library that compiles its file;
- a ``SIGNATURES`` entry that its library's file does not export;
- an argtypes list whose length differs from the C parameter count;
- a (dtype code, head width) case of ``_KERNEL_DTYPES`` x
  (``_KERNEL_HEAD_DIMS`` and ``_KERNEL_WIDE``) that the dispatch lacks, a
  dispatch case, narrow or wide, the Python side does not name, and a code
  whose C type is not its torch dtype's.

The reference's ABI-version literal has no counterpart: a library's file
name carries the digest of its sources (``_build.library_path``), so a
stale build is never loaded.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.lint.base import Reporter

# an entry point's definition, up to its open paren
_EXPORT_RE = re.compile(r'^\s*extern\s+"C"\s+int\s+(hvd_\w+)\s*\(',
                        re.MULTILINE)
# one dispatch case: HVD_FLASH_CASE(code, C type, width, ...
_CASE_RE = re.compile(r"HVD_FLASH_CASE\(\s*(\d+)\s*,\s*([\w:]+)\s*,\s*"
                      r"(\d+)\s*,")
# one wide case: HVD_FLASH_WIDE_CASE(code, C type, ...; its head width is
# the code that `#define HVD_FLASH_WIDE` gives
_WIDE_CASE_RE = re.compile(r"HVD_FLASH_WIDE_CASE\(\s*(\d+)\s*,\s*"
                           r"([\w:]+)\s*,")
_WIDE_CODE_RE = re.compile(r"#define\s+HVD_FLASH_WIDE\s+(\d+)")
# torch dtype name -> the C type its code instantiates (last component)
C_TYPE = {"float32": "float", "bfloat16": "bf16", "float16": "f16"}


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def param_count(text: str, open_paren: int) -> int:
    """Parameters of the C declaration whose '(' is at ``open_paren``."""
    depth, start = 0, open_paren + 1
    args: List[str] = []
    for i in range(open_paren, len(text)):
        ch = text[i]
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                args.append(text[start:i])
                break
        elif ch == "," and depth == 1:
            args.append(text[start:i])
            start = i + 1
    args = [a.strip() for a in args]
    return 0 if args in ([""], ["void"]) else len(args)


def parse_exports(text: str) -> Dict[str, Tuple[int, int]]:
    """{symbol: (parameter count, line)} of a CUDA source."""
    return {m.group(1): (param_count(text, m.end() - 1),
                         _line(text, m.start(1)))
            for m in _EXPORT_RE.finditer(text)}


def parse_dispatch(text: str) -> Dict[Tuple[int, int], Tuple[str, int]]:
    """{(dtype code, head width): (C type, line)} of the dispatch cases; a
    wide case's head width is ``HVD_FLASH_WIDE``'s code (-1 if the text
    does not define it)."""
    cases = {(int(m.group(1)), int(m.group(3))):
             (m.group(2).split("::")[-1], _line(text, m.start()))
             for m in _CASE_RE.finditer(text)}
    code = _WIDE_CODE_RE.search(text)
    wide = int(code.group(1)) if code else -1
    cases.update({(int(m.group(1)), wide):
                  (m.group(2).split("::")[-1], _line(text, m.start()))
                  for m in _WIDE_CASE_RE.finditer(text)})
    return cases


def _assigned(tree: ast.AST, name: str) -> Optional[ast.Assign]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == name:
            return node
    return None


def parse_build(tree: ast.AST):
    """(``SOURCES`` {library: file}, ``SIGNATURES`` {symbol: (library,
    argtypes length, line)}) of ``_build.py``."""
    sources: Dict[str, str] = {}
    node = _assigned(tree, "SOURCES")
    if node is not None and isinstance(node.value, ast.Dict):
        for k, v in zip(node.value.keys, node.value.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                sources[k.value] = v.value
    signatures: Dict[str, Tuple[str, int, int]] = {}
    node = _assigned(tree, "SIGNATURES")
    if node is not None and isinstance(node.value, ast.Dict):
        for k, v in zip(node.value.keys, node.value.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Tuple) and \
                    len(v.elts) == 2 and isinstance(v.elts[0], ast.Constant) \
                    and isinstance(v.elts[1], ast.List):
                signatures[k.value] = (v.elts[0].value, len(v.elts[1].elts),
                                       k.lineno)
    return sources, signatures


def parse_kernel_cases(tree: ast.AST):
    """(``_KERNEL_DTYPES`` {torch dtype name: code}, its line,
    ``_KERNEL_HEAD_DIMS`` widths, its line, ``_KERNEL_WIDE``'s code or
    None, its line) of ``flash_attention.py``."""
    dtypes: Dict[str, int] = {}
    dtypes_line = widths_line = 1
    node = _assigned(tree, "_KERNEL_DTYPES")
    if node is not None and isinstance(node.value, ast.Dict):
        dtypes_line = node.lineno
        for k, v in zip(node.value.keys, node.value.values):
            if isinstance(k, ast.Attribute) and isinstance(v, ast.Constant):
                dtypes[k.attr] = v.value
    widths: List[int] = []
    node = _assigned(tree, "_KERNEL_HEAD_DIMS")
    if node is not None and isinstance(node.value, (ast.Tuple, ast.List)):
        widths_line = node.lineno
        widths = [e.value for e in node.value.elts
                  if isinstance(e, ast.Constant)]
    wide, wide_line = None, widths_line
    node = _assigned(tree, "_KERNEL_WIDE")
    if node is not None and isinstance(node.value, ast.Constant):
        wide, wide_line = node.value.value, node.lineno
    return dtypes, dtypes_line, widths, widths_line, wide, wide_line


def _parse_py(rep: Reporter, path: Path):
    fr = rep.scan_file(path)
    try:
        return fr, ast.parse(fr.text, filename=str(path))
    except SyntaxError:
        return fr, None


def check_kernel_abi(rep: Reporter, ops_dir: Path) -> None:
    """HVL104 over one ops directory: ``_build.py``, ``flash_attention.py``
    and ``csrc/``."""
    build_py = ops_dir / "_build.py"
    kernels_py = ops_dir / "flash_attention.py"
    csrc = ops_dir / "csrc"
    if not build_py.is_file() or not csrc.is_dir():
        return
    b_fr, b_tree = _parse_py(rep, build_py)
    if b_tree is None:
        return
    sources, signatures = parse_build(b_tree)
    lib_of_file = {f: lib for lib, f in sources.items()}

    exports: Dict[str, Dict[str, Tuple[int, int]]] = {}  # file -> symbols
    dispatch: Dict[Tuple[int, int], Tuple[str, int, Path]] = {}
    for path in sorted(csrc.iterdir()):
        if path.suffix not in (".cu", ".cuh"):
            continue
        fr = rep.scan_file(path)
        if path.suffix == ".cu":
            exports[path.name] = parse_exports(fr.text)
            lib = lib_of_file.get(path.name)
            for sym, (_, line) in sorted(exports[path.name].items()):
                if sym not in signatures or signatures[sym][0] != lib:
                    fr.add("HVL104", line,
                           f"C export `{sym}` is not bound in "
                           f"{build_py.name}'s SIGNATURES under library "
                           f"`{lib}` (which compiles {path.name}) — an "
                           "unbound entry point drifts silently")
        for case, (ctype, line) in parse_dispatch(fr.text).items():
            dispatch[case] = (ctype, line, path)

    for sym, (lib, nargs, line) in sorted(signatures.items()):
        src = sources.get(lib)
        exported = exports.get(src, {}) if src else {}
        if sym not in exported:
            b_fr.add("HVL104", line,
                     f"SIGNATURES binds `{sym}` to library `{lib}`, but "
                     f"{src or 'no source'} does not export it")
        elif exported[sym][0] != nargs:
            b_fr.add("HVL104", line,
                     f"`{sym}` argtypes declare {nargs} parameter(s) but "
                     f"the C signature in {src} takes {exported[sym][0]} "
                     "— ctypes would cut or shift the arguments")

    if not kernels_py.is_file():
        return
    k_fr, k_tree = _parse_py(rep, kernels_py)
    if k_tree is None:
        return
    dtypes, dtypes_line, widths, widths_line, wide, wide_line = \
        parse_kernel_cases(k_tree)
    named = {(code, w) for code in dtypes.values()
             for w in widths + ([] if wide is None else [wide])}
    for code, w in sorted(named - set(dispatch)):
        k_fr.add("HVL104", wide_line if w == wide else widths_line,
                 f"_KERNEL_DTYPES x _KERNEL_HEAD_DIMS/_KERNEL_WIDE names "
                 f"(dtype {code}, head_dim {w}), which HVD_FLASH_DISPATCH "
                 "lacks — the launch would return cudaErrorInvalidValue")
    for (code, w) in sorted(set(dispatch) - named):
        _, line, path = dispatch[(code, w)]
        rep.scan_file(path).add(
            "HVL104", line,
            f"HVD_FLASH_DISPATCH instantiates (dtype {code}, head_dim {w}), "
            f"which _KERNEL_DTYPES x _KERNEL_HEAD_DIMS/_KERNEL_WIDE in "
            f"{kernels_py.name} does not name")
    for name, code in sorted(dtypes.items()):
        want = C_TYPE.get(name)
        for (c, w), (ctype, line, path) in sorted(dispatch.items()):
            if c == code and ctype != want:
                k_fr.add("HVL104", dtypes_line,
                         f"dtype code {code} is torch.{name} here but "
                         f"`{ctype}` in {path.name}:{line} (head_dim {w})")
