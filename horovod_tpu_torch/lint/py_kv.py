"""KV-key discipline rules (HVL007-HVL008).

Counterpart of ``horovod_tpu/lint/py_kv.py`` over the port's registry:
every rendezvous-KV key family is declared once in
``horovod_tpu_torch/common/kv_keys.py``; these rules enforce the two
sides of that contract:

- HVL007 — KV keys must be built through the typed builders, never as
  raw strings. Flagged: f-strings whose literal head is a registered
  family prefix, plain string literals starting with one (concatenation
  counts), and singleton key names (``"generation"``, ``"notify"``, ...)
  passed directly to a KV accessor. Docstrings are exempt (patterns are
  documentation), as is ``kv_keys.py`` itself.
- HVL008 — driver-originated KV mutations must claim the control epoch.
  In any module that owns a ``KVServer`` (the driver side), every
  ``put_json``/``delete``/``delete_prefix`` call must pass ``epoch=`` —
  an epoch-less driver write is invisible to the KV's split-brain
  fencing (``runner/http_kv.py``) and to the conformance replay
  (``verify/conformance.py``).
"""

from __future__ import annotations

import ast
from pathlib import Path

from horovod_tpu_torch.common.kv_keys import singleton_names, slash_prefixes
from horovod_tpu_torch.lint.base import Reporter

# KV accessor spellings whose first argument is a key: the KV
# client/server methods, the router's local-getter convention, and the
# driver's publish/_publish wrappers (every driver command write goes
# through those — leaving them out would exempt the most
# protocol-critical keys from the rule)
_KV_ACCESSORS = {"put_json", "get_json", "kv_get_json", "kv_put_json",
                 "delete", "delete_prefix", "keys", "publish", "_publish"}
_MUTATORS = {"put_json", "delete", "delete_prefix"}


def _docstring_ids(tree: ast.AST) -> set:
    """id()s of Constant nodes that are docstrings."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant) and \
                    isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def _prefix_hit(text: str, prefixes) -> str | None:
    for p in prefixes:
        if text.startswith(p):
            return p
    return None


def check_python_kv_keys(rep: Reporter, path: Path):
    """HVL007 for one Python file."""
    if path.name == "kv_keys.py":
        return  # the registry builds its own keys, by definition
    fr = rep.scan_file(path)
    try:
        tree = ast.parse(fr.text, filename=str(path))
    except SyntaxError:
        return  # the collectives checker already reports parse failures
    prefixes = tuple(slash_prefixes())
    singles = singleton_names()
    skip = _docstring_ids(tree)
    # constituents of f-strings are flagged once, as the f-string
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            skip.update(id(v) for v in node.values)

    def flag(line: int, key_text: str, how: str):
        fr.add(
            "HVL007", line,
            f"raw KV key construction ({how}: `{key_text}`) — build the "
            "key through horovod_tpu_torch.common.kv_keys so the namespace "
            "stays typed and the protocol specs/conformance checker see "
            "the same prefixes the runtime uses")

    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr) and node.values and \
                isinstance(node.values[0], ast.Constant):
            head = str(node.values[0].value)
            p = _prefix_hit(head, prefixes)
            if p is not None:
                flag(node.lineno, head + "...", "f-string")
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and id(node) not in skip:
            p = _prefix_hit(node.value, prefixes)
            if p is not None:
                flag(node.lineno, node.value, "string literal")
        elif isinstance(node, ast.Call):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if fname in _KV_ACCESSORS and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    node.args[0].value in singles:
                flag(node.lineno, node.args[0].value,
                     f"singleton key passed to {fname}()")


def check_python_kv_epochs(rep: Reporter, path: Path):
    """HVL008 for one Python file: only files that instantiate a
    ``KVServer`` are in scope (the driver side owns the epoch; workers'
    KVClient writes are epoch-less by design)."""
    if path.name == "http_kv.py":
        return  # the KV implementation itself
    fr = rep.scan_file(path)
    try:
        tree = ast.parse(fr.text, filename=str(path))
    except SyntaxError:
        return
    owns_server = any(
        isinstance(node, ast.Call) and (
            (isinstance(node.func, ast.Name) and
             node.func.id == "KVServer") or
            (isinstance(node.func, ast.Attribute) and
             node.func.attr == "KVServer"))
        for node in ast.walk(tree))
    if not owns_server:
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in _MUTATORS):
            continue
        if any(kw.arg == "epoch" for kw in node.keywords):
            continue
        fr.add(
            "HVL008", node.lineno,
            f"driver-originated KV write (`{f.attr}`) without an epoch "
            "claim — pass `epoch=` so the KV can fence a stale driver "
            "and the WAL records the claim for conformance replay "
            "(runner/http_kv.py fencing)")
