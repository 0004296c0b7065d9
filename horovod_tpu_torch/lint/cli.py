"""``python -m horovod_tpu_torch.lint`` — static collective-safety, env
and KV-key analysis of the port.

Usage::

    python -m horovod_tpu_torch.lint [paths...]    # default: the port
    python -m horovod_tpu_torch.lint --rules HVL003,HVL005
    python -m horovod_tpu_torch.lint --write-env-table
    python -m horovod_tpu_torch.lint --list-rules

Counterpart of ``horovod_tpu/lint/cli.py`` (``hvd-lint``) with the Python
rules HVL001-HVL008 and HVL104 over the kernel ABI. The default scan roots
are ``horovod_tpu_torch/`` and ``chip_smoke.py``; directories named
``*lint_fixtures`` are skipped, and a full run also checks README.md's env
table (HVL006) and ``horovod_tpu_torch/ops``'s kernel ABI (HVL104). Given
paths, HVL104 reads each directory among them that holds a ``_build.py``
and a ``csrc/``.

Exit status: 0 clean, 1 findings, 2 usage error.
``tests/test_torch_lint.py`` runs the full suite on the port and asserts
zero findings, which makes every rule a tier-1 gate.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from horovod_tpu_torch.lint.abi_rules import check_kernel_abi
from horovod_tpu_torch.lint.base import (RULES, Finding, Reporter,
                                         iter_source_files)
from horovod_tpu_torch.lint.py_collectives import check_python_collectives
from horovod_tpu_torch.lint.py_env import (check_doc_sync, check_python_env,
                                           write_env_table)
from horovod_tpu_torch.lint.py_kv import (check_python_kv_epochs,
                                          check_python_kv_keys)

# the scan roots relative to the repo root
PY_ROOTS = ("horovod_tpu_torch", "chip_smoke.py")
OPS_DIR = "horovod_tpu_torch/ops"  # the kernel ABI's two sides (HVL104)
EXCLUDE_DIRS = ("*lint_fixtures",)
ENV_DOC = "README.md"


def find_repo_root() -> Path:
    """The directory holding the ``horovod_tpu_torch`` package."""
    return Path(__file__).resolve().parents[2]


def run_lint(repo_root: Optional[Path] = None,
             paths: Optional[List[Path]] = None,
             rules: Optional[set] = None) -> List[Finding]:
    """Run every (selected) rule; returns deduplicated findings sorted by
    path/line. ``paths`` overrides the default scan roots (files or
    directories) and skips the README check."""
    root = Path(repo_root) if repo_root else find_repo_root()
    rep = Reporter(root)
    if paths:
        py_files = iter_source_files(paths, (".py",))
    else:
        py_files = iter_source_files([root / p for p in PY_ROOTS], (".py",),
                                     extra_exclude_dirs=EXCLUDE_DIRS)

    def on(rule: str) -> bool:
        return rules is None or rule in rules

    for f in py_files:
        if on("HVL001") or on("HVL002") or on("HVL003"):
            check_python_collectives(rep, f)
        if on("HVL004") or on("HVL005"):
            check_python_env(rep, f)
        if on("HVL007"):
            check_python_kv_keys(rep, f)
        if on("HVL008"):
            check_python_kv_epochs(rep, f)
    if not paths and on("HVL006"):
        check_doc_sync(rep, root / ENV_DOC)
    if on("HVL104"):
        abi_dirs = [root / OPS_DIR] if not paths else \
            [Path(p) for p in paths if (Path(p) / "_build.py").is_file()]
        for ops_dir in abi_dirs:
            check_kernel_abi(rep, ops_dir)

    if rules is not None:
        rep.findings = [f for f in rep.findings if f.rule in rules]
    # nested rank-dependent branches can flag the same call twice —
    # collapse exact duplicates, keep stable order
    seen, out = set(), []
    for f in sorted(rep.findings, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.lint",
        description="static collective-safety, env, KV-key and kernel-ABI "
                    "analysis of horovod_tpu_torch")
    p.add_argument("paths", nargs="*", type=Path,
                   help="files/directories to scan (default: "
                        f"{', '.join(PY_ROOTS)} + the {ENV_DOC} env table)")
    p.add_argument("--rules", help="comma-separated rule ids to run")
    p.add_argument("--write-env-table", action="store_true",
                   help=f"regenerate the env table in {ENV_DOC} from "
                        "common/env.py, then exit")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable findings")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--repo-root", type=Path, default=None)
    args = p.parse_args(argv)

    if args.list_rules:
        for rid, doc in sorted(RULES.items()):
            print(f"{rid}  {doc}")
        return 0

    root = args.repo_root or find_repo_root()
    if args.write_env_table:
        changed = write_env_table(root / ENV_DOC)
        print(f"{ENV_DOC}: env table "
              f"{'updated' if changed else 'already current'}")
        return 0

    rules = None
    if args.rules:
        rules = {r.strip().upper() for r in args.rules.split(",")}
        unknown = rules - set(RULES)
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)} "
                  f"(known: {sorted(RULES)})", file=sys.stderr)
            return 2

    findings = run_lint(repo_root=root, paths=args.paths or None,
                        rules=rules)
    if args.as_json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        scope = "the port" if not args.paths else f"{len(args.paths)} path(s)"
        print(f"hvd-lint: {len(findings)} finding(s) over {scope}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
