"""Env-var discipline rules (HVL004-HVL006).

Counterpart of ``horovod_tpu/lint/py_env.py`` over the port's registry:
every ``HOROVOD_*`` variable the port reads or sets is declared once in
``horovod_tpu_torch/common/env.py``; these rules enforce the three sides
of that contract:

- HVL004 — Python code must read HOROVOD_* through the typed accessors,
  never ``os.environ``/``os.getenv`` directly (writes are allowed — the
  launcher builds child environments by hand).
- HVL005 — any ``HOROVOD_*`` name appearing in the tree (Python string
  literals, docstrings included) must be a registered name. Unknown names
  get an edit-distance suggestion, so a misspelled cycle-time knob says
  "did you mean HOROVOD_CYCLE_TIME" instead of silently becoming a
  default at runtime (``env._raw`` raises ``KeyError`` for a name read
  through the accessors, but a name only written for a child process, or
  read by ``dict.get`` on a spec's env, reaches no accessor). A name
  ending in ``_`` (``HOROVOD_TUNE_*`` in a help text) is a prefix, and
  passes when some registered name starts with it.
- HVL006 — the env table embedded in ``README.md``'s port section between
  ``<!-- torch-env-table:begin -->`` / ``<!-- torch-env-table:end -->``
  must equal the generated table (``python -m horovod_tpu_torch.lint
  --write-env-table``).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from horovod_tpu_torch.common.env import REGISTRY, render_env_table
from horovod_tpu_torch.lint.base import Reporter

_ENV_NAME_RE = re.compile(r"\bHOROVOD_[A-Z][A-Z0-9_]+\b")

TABLE_BEGIN = "<!-- torch-env-table:begin -->"
TABLE_END = "<!-- torch-env-table:end -->"


def edit_distance(a: str, b: str, cap: int = 4) -> int:
    """Levenshtein with an early-out cap (names are short, candidates
    few)."""
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        if min(cur) > cap:
            return cap + 1
        prev = cur
    return prev[-1]


def nearest_registered(name: str):
    """(best_name, distance) over the registry."""
    best, best_d = None, 10 ** 9
    for cand in REGISTRY:
        d = edit_distance(name, cand)
        if d < best_d:
            best, best_d = cand, d
    return best, best_d


def _unknown_name_message(name: str) -> str:
    best, d = nearest_registered(name)
    if best is not None and d <= 2:
        return (f"`{name}` is not in the env registry — did you mean "
                f"`{best}`? (edit distance {d})")
    return (f"`{name}` is not in the env registry; declare it in "
            "horovod_tpu_torch/common/env.py (name, default, doc) so the "
            "env table and typo check cover it")


def _registered_prefix(name: str) -> bool:
    """A match ending in ``_`` names a family of variables (``HOROVOD_TUNE_*``
    in a help text): it passes when it is the prefix of a registered name."""
    return name.endswith("_") and any(r.startswith(name) for r in REGISTRY)


def _env_key_literal(node) -> str | None:
    """The HOROVOD_* key of a read expression, if statically known."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith("HOROVOD_"):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values and \
            isinstance(node.values[0], ast.Constant) and \
            str(node.values[0].value).startswith("HOROVOD_"):
        return str(node.values[0].value) + "..."
    return None


def _is_os_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


class _EnvReadChecker(ast.NodeVisitor):
    def __init__(self, fr):
        self.fr = fr

    def _flag(self, line: int, key: str, how: str):
        self.fr.add(
            "HVL004", line,
            f"direct {how} of `{key}` — route the read through "
            "horovod_tpu_torch.common.env (env_str/env_int/env_float/"
            "env_bool/env_raw/env_is_set) so typos fail loudly and the "
            "env table stays complete")

    def visit_Subscript(self, node: ast.Subscript):
        # os.environ["X"] — only reads (Load); writes/deletes are the
        # launcher's job and stay allowed
        if _is_os_environ(node.value) and isinstance(node.ctx, ast.Load):
            key = _env_key_literal(node.slice)
            if key:
                self._flag(node.lineno, key, "os.environ[...] read")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and node.args:
            key = _env_key_literal(node.args[0])
            if key:
                if _is_os_environ(f.value) and f.attr in ("get",
                                                          "setdefault"):
                    self._flag(node.lineno, key, f"os.environ.{f.attr}()")
                elif isinstance(f.value, ast.Name) and f.value.id == "os" \
                        and f.attr == "getenv":
                    self._flag(node.lineno, key, "os.getenv()")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        # "HOROVOD_X" in os.environ
        if len(node.ops) == 1 and isinstance(node.ops[0],
                                             (ast.In, ast.NotIn)) and \
                _is_os_environ(node.comparators[0]):
            key = _env_key_literal(node.left)
            if key:
                self._flag(node.lineno, key,
                           "`in os.environ` membership test")
        self.generic_visit(node)


def check_python_env(rep: Reporter, path: Path):
    """HVL004 (direct reads) + HVL005 (unknown names in string literals,
    docstrings included) for one Python file."""
    fr = rep.scan_file(path)
    try:
        tree = ast.parse(fr.text, filename=str(path))
    except SyntaxError:
        return  # the collectives checker already reports parse failures
    if path.name != "env.py":
        _EnvReadChecker(fr).visit(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in _ENV_NAME_RE.finditer(node.value):
                name = m.group(0)
                if name not in REGISTRY and not _registered_prefix(name):
                    fr.add("HVL005", node.lineno,
                           _unknown_name_message(name))


def check_doc_sync(rep: Reporter, doc: Path):
    """HVL006: the README's port env table must equal the generated
    one."""
    if not doc.exists():
        rep.add_repo_finding("HVL006", doc, 1, f"{doc.name} is missing")
        return
    text = doc.read_text()
    if TABLE_BEGIN not in text or TABLE_END not in text:
        rep.add_repo_finding(
            "HVL006", doc, 1,
            f"env-table markers not found ({TABLE_BEGIN} ... {TABLE_END});"
            " add them where the table belongs, then run `python -m "
            "horovod_tpu_torch.lint --write-env-table`")
        return
    begin = text.index(TABLE_BEGIN) + len(TABLE_BEGIN)
    end = text.index(TABLE_END)
    embedded = text[begin:end].strip("\n")
    expected = render_env_table().strip("\n")
    if embedded != expected:
        line = text[:begin].count("\n") + 1
        emb_rows = {r for r in embedded.splitlines() if r.startswith("| `")}
        exp_rows = {r for r in expected.splitlines() if r.startswith("| `")}

        def names(rows):
            return {r.split("`")[1] for r in rows if "`" in r}
        missing = sorted(names(exp_rows) - names(emb_rows))
        stale = sorted(names(emb_rows) - names(exp_rows))
        detail = []
        if missing:
            detail.append(f"missing from docs: {missing}")
        if stale:
            detail.append(f"stale in docs: {stale}")
        if not detail:
            detail.append("row content drifted (type/default/doc)")
        rep.add_repo_finding(
            "HVL006", doc, line,
            "env table out of sync with common/env.py — " +
            "; ".join(detail) +
            " (regenerate: `python -m horovod_tpu_torch.lint "
            "--write-env-table`)")


def write_env_table(doc: Path) -> bool:
    """Replace the embedded table with the generated one. Returns True if
    the file changed."""
    text = doc.read_text()
    if TABLE_BEGIN not in text or TABLE_END not in text:
        raise SystemExit(
            f"{doc}: env-table markers not found; add\n"
            f"{TABLE_BEGIN}\n{TABLE_END}\nwhere the table belongs")
    begin = text.index(TABLE_BEGIN) + len(TABLE_BEGIN)
    end = text.index(TABLE_END)
    new = text[:begin] + "\n" + render_env_table() + text[end:]
    if new != text:
        doc.write_text(new)
        return True
    return False
