"""Shared lint infrastructure: findings, rule metadata, suppression
comments, and file discovery.

Counterpart of ``horovod_tpu/lint/base.py``, with the Python rules
(HVL001-HVL008) and HVL104 over the port's kernel ABI: the port has no C++
engine, and its CUDA sources hold no condition variable, lock or host
atomic for the reference's HVL101-HVL103 to read.

Suppression syntax:

- ``# hvd-lint: disable=HVL001`` on the flagged line or the line
  directly above suppresses the listed rule(s) there; comma-separate
  several ids; omitting ``=ids`` suppresses every rule on that line.
- ``# hvd-lint: disable-file=HVL003`` anywhere in the first 10 lines
  suppresses the rule(s) for the whole file.

Suppressions are deliberate, reviewable artifacts: every exception to a
contract is written down next to the code that needs it, with its
reason.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

# rule id -> one-line description (``--list-rules`` prints these)
RULES: Dict[str, str] = {
    "HVL001": "collective reachable only under rank-dependent control flow "
              "(static counterpart of the runtime desync detector)",
    "HVL002": "if/else branches on a rank-dependent condition issue "
              "different collective sequences",
    "HVL003": "broad except can swallow HorovodInternalError or "
              "DistBackendError around a collective without re-raising "
              "(breaks fast-abort)",
    "HVL004": "direct os.environ read of a HOROVOD_* variable — use the "
              "typed accessors in common/env.py",
    "HVL005": "HOROVOD_* name not in the env registry (typo suggestions "
              "by edit distance)",
    "HVL006": "README.md's port env table out of sync with the registry "
              "(regenerate with --write-env-table)",
    "HVL007": "raw string KV-key construction outside the typed key "
              "registry (common/kv_keys.py)",
    "HVL008": "driver-originated KV write missing an epoch claim "
              "(invisible to split-brain fencing and conformance replay)",
    "HVL104": "kernel ABI drift: an hvd_* C export vs ops/_build.py "
              "SIGNATURES (binding, arity), or the dispatch's (dtype, "
              "head_dim) cases vs _KERNEL_DTYPES/_KERNEL_HEAD_DIMS",
}

_DISABLE_RE = re.compile(
    r"#\s*hvd-lint:\s*disable(?P<file>-file)?(?:=(?P<ids>[A-Z0-9, ]+))?")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str   # repo-relative, forward slashes
    line: int   # 1-based
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Suppressions:
    """Per-file suppression state parsed once from the source text."""
    file_rules: Optional[set] = None  # None = no file-level disable
    by_line: Dict[int, Optional[set]] = field(default_factory=dict)
    # by_line value None = all rules disabled on that line

    def active(self, rule: str, line: int) -> bool:
        if self.file_rules is not None and (
                not self.file_rules or rule in self.file_rules):
            return True
        for ln in (line, line - 1):
            if ln in self.by_line:
                ids = self.by_line[ln]
                if ids is None or rule in ids:
                    return True
        return False


def parse_suppressions(text: str) -> Suppressions:
    sup = Suppressions()
    for i, raw in enumerate(text.splitlines(), start=1):
        m = _DISABLE_RE.search(raw)
        if not m:
            continue
        ids = m.group("ids")
        rule_set = ({r.strip() for r in ids.split(",") if r.strip()}
                    if ids else None)
        if m.group("file") and i <= 10:
            sup.file_rules = rule_set or set()  # empty set = all rules
        else:
            sup.by_line[i] = rule_set
    return sup


class Reporter:
    """Collects findings, applying suppressions for the file being
    scanned."""

    def __init__(self, repo_root: Path):
        self.repo_root = Path(repo_root)
        self.findings: List[Finding] = []
        self._file_cache: Dict[Path, "FileReporter"] = {}

    def scan_file(self, path: Path) -> "FileReporter":
        # Several rule families scan the same file; read and parse
        # suppressions once per path, not once per rule.
        fr = self._file_cache.get(path)
        if fr is None:
            text = path.read_text(errors="replace")
            fr = self._file_cache[path] = FileReporter(self, path, text)
        return fr

    def add_repo_finding(self, rule: str, path: Path, line: int,
                         message: str):
        """A finding not tied to one scanned file's suppression state
        (e.g. the doc-sync rule)."""
        self.findings.append(
            Finding(rule, self._rel(path), line, message))

    def _rel(self, path: Path) -> str:
        path = Path(path)
        if not path.is_absolute():
            return path.as_posix()
        try:
            return path.resolve().relative_to(
                self.repo_root.resolve()).as_posix()
        except ValueError:
            return path.as_posix()


class FileReporter:
    def __init__(self, parent: Reporter, path: Path, text: str):
        self.parent = parent
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.suppressions = parse_suppressions(text)

    def add(self, rule: str, line: int, message: str):
        if self.suppressions.active(rule, line):
            return
        self.parent.findings.append(
            Finding(rule, self.parent._rel(self.path), line, message))


# Compiled artifacts and caches: scanning these would be slow and
# meaningless, so they are excluded by default.
DEFAULT_EXCLUDE_DIRS = ("__pycache__", ".git", ".pytest_cache", "node_modules")
DEFAULT_EXCLUDE_DIR_GLOBS = ("build*",)
DEFAULT_EXCLUDE_SUFFIXES = (".o", ".so", ".pyc", ".a", ".d")


def iter_source_files(roots: Sequence[Path],
                      suffixes: Iterable[str],
                      extra_exclude_dirs: Sequence[str] = ()) -> List[Path]:
    """Walk ``roots`` (files or directories) yielding sources with one of
    ``suffixes``, skipping the default exclude list (build*/, __pycache__,
    compiled artifacts) plus ``extra_exclude_dirs``: directory names, or
    ``fnmatch`` patterns of them (``*lint_fixtures``)."""
    import fnmatch
    suffixes = tuple(suffixes)
    out: List[Path] = []

    def excluded_dir(name: str) -> bool:
        if name in DEFAULT_EXCLUDE_DIRS:
            return True
        return any(fnmatch.fnmatch(name, g) for g in
                   DEFAULT_EXCLUDE_DIR_GLOBS + tuple(extra_exclude_dirs))

    def walk(p: Path):
        if p.is_dir():
            if excluded_dir(p.name):
                return
            for child in sorted(p.iterdir()):
                walk(child)
        elif p.suffix in suffixes and \
                p.suffix not in DEFAULT_EXCLUDE_SUFFIXES:
            out.append(p)

    for root in roots:
        root = Path(root)
        if root.exists():
            # explicit file arguments bypass the directory-name excludes
            if root.is_file():
                if root.suffix in suffixes:
                    out.append(root)
            else:
                for child in sorted(root.iterdir()):
                    walk(child)
    return out
