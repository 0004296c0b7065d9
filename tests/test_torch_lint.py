"""The port's lint (``horovod_tpu_torch.lint``): a trigger and a clean
fixture per rule in the port's idiom (``tests/torch_lint_fixtures/``),
the collective rules equal to the reference's over its own fixtures,
suppressions, the typo suggestion, the README env table, the CLI's exit
codes, and the gate: the port itself lints clean."""

import json
from pathlib import Path

import pytest

from horovod_tpu.lint import run_lint as ref_run_lint
from horovod_tpu_torch.common import kv_keys
from horovod_tpu_torch.common.env import REGISTRY, render_env_table
from horovod_tpu_torch.lint import RULES, run_lint
from horovod_tpu_torch.lint.base import Reporter, iter_source_files
from horovod_tpu_torch.lint.cli import main as lint_main
from horovod_tpu_torch.lint.py_env import (TABLE_BEGIN, TABLE_END,
                                           check_doc_sync, edit_distance,
                                           nearest_registered,
                                           write_env_table)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "torch_lint_fixtures"
REF_FIXTURES = Path(__file__).parent / "lint_fixtures"


def rules_in(*names, rules=None):
    findings = run_lint(repo_root=REPO,
                        paths=[FIXTURES / n for n in names], rules=rules)
    return findings, sorted({f.rule for f in findings})


# -- per-rule fixtures: one trigger + one clean case each ----------------

@pytest.mark.parametrize("rule", ["HVL001", "HVL002", "HVL003", "HVL004",
                                  "HVL005", "HVL007", "HVL008"])
def test_rule_fixture_pair(rule):
    n = rule[-1]
    trigger, clean = f"hvl00{n}_trigger.py", f"hvl00{n}_clean.py"
    _, fired = rules_in(trigger, rules={rule})
    assert fired == [rule], f"{trigger} must trigger {rule}, got {fired}"
    # the clean fixture is clean under every rule, not just its own
    findings, _ = rules_in(clean)
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("rule,lines", [
    ("HVL001", [9, 15, 20]),   # guarded all_reduce, early exit, while
    ("HVL002", [7]),
    ("HVL003", [10, 18, 27]),  # Exception, bare, one abort error routed
    ("HVL004", [6, 7, 8, 9]),  # get, [], in, getenv
    ("HVL005", [6, 10, 14]),   # typo, unknown, prefix of nothing
    ("HVL007", [6, 11, 16]),   # f-string, literal, singleton
    ("HVL008", [13, 16, 17, 20]),  # put_json, delete_prefix, delete,
                                   # an epoch-less family's key
])
def test_trigger_lines(rule, lines):
    n = rule[-1]
    findings, _ = rules_in(f"hvl00{n}_trigger.py", rules={rule})
    assert [f.line for f in findings] == lines, \
        [f.render() for f in findings]


@pytest.mark.parametrize("rule", ["HVL001", "HVL002", "HVL003"])
@pytest.mark.parametrize("kind", ["trigger", "clean"])
def test_collective_rules_equal_reference_on_its_fixtures(rule, kind):
    """The port's HVL001-HVL003 over the reference's own fixtures give the
    reference's (rule, line) findings."""
    path = REF_FIXTURES / f"hvl00{rule[-1]}_{kind}.py"
    got = run_lint(repo_root=REPO, paths=[path], rules={rule})
    want = ref_run_lint(repo_root=REPO, paths=[path], rules={rule})
    assert [(f.rule, f.line) for f in got] == \
        [(f.rule, f.line) for f in want]
    assert bool(got) == (kind == "trigger")


@pytest.mark.parametrize("rule", ["HVL007", "HVL008"])
@pytest.mark.parametrize("kind", ["trigger", "clean"])
def test_kv_rules_equal_reference_on_its_fixtures(rule, kind):
    """The port's HVL007-HVL008 over the reference's own fixtures give the
    reference's (rule, line) findings: HVL008 exempts no key family."""
    path = REF_FIXTURES / f"hvl00{rule[-1]}_{kind}.py"
    got = run_lint(repo_root=REPO, paths=[path], rules={rule})
    want = ref_run_lint(repo_root=REPO, paths=[path], rules={rule})
    assert [(f.rule, f.line) for f in got] == \
        [(f.rule, f.line) for f in want]
    assert bool(got) == (kind == "trigger")


def test_hvl002_names_both_sequences():
    findings, _ = rules_in("hvl002_trigger.py", rules={"HVL002"})
    assert len(findings) == 1
    assert "['all_reduce', 'broadcast'] vs ['broadcast', 'all_reduce']" \
        in findings[0].message


def test_hvl003_names_both_abort_errors():
    findings, _ = rules_in("hvl003_trigger.py", rules={"HVL003"})
    assert all("HorovodInternalError or DistBackendError" in f.message
               for f in findings)


def test_hvl007_names_all_three_forms():
    findings, _ = rules_in("hvl007_trigger.py", rules={"HVL007"})
    messages = "\n".join(f.message for f in findings)
    assert "f-string" in messages and "string literal" in messages
    assert "singleton key passed to put_json()" in messages


def test_hvl008_ignores_client_only_modules():
    # hvl007_trigger.py owns no KVServer: epoch-less writes by design
    _, fired = rules_in("hvl007_trigger.py", rules={"HVL008"})
    assert fired == []


def test_kv_key_scan_lists_cover_the_registry():
    singles, prefixes = kv_keys.singleton_names(), kv_keys.slash_prefixes()
    assert set(singles.values()) | set(prefixes.values()) == \
        set(kv_keys.FAMILIES)
    assert singles["notify"] == "notify"
    assert prefixes["drain/"] == "drain"
    from horovod_tpu.common import kv_keys as ref_kv_keys
    assert singles == ref_kv_keys.singleton_names()
    assert prefixes == ref_kv_keys.slash_prefixes()


# -- suppressions ----------------------------------------------------------

@pytest.mark.parametrize("name", ["suppressed.py", "file_suppressed.py"])
def test_suppression_comments_silence_rules(name):
    findings = run_lint(repo_root=REPO, paths=[FIXTURES / name])
    assert findings == [], [f.render() for f in findings]


def test_suppression_applies_only_to_its_lines(tmp_path):
    src = (FIXTURES / "suppressed.py").read_text()
    moved = tmp_path / "moved.py"
    moved.write_text(src.replace("    # hvd-lint: disable=HVL003 - "
                                 "benchmark probe, failure means skip\n",
                                 ""))
    findings = run_lint(repo_root=tmp_path, paths=[moved])
    assert [f.rule for f in findings] == ["HVL003"]


# -- env registry: typo suggestion and the README table ---------------------

def test_env_typo_suggests_nearest_name():
    findings, _ = rules_in("hvl005_trigger.py", rules={"HVL005"})
    by_msg = "\n".join(f.message for f in findings)
    assert "did you mean `HOROVOD_CYCLE_TIME`" in by_msg
    assert "declare it in horovod_tpu_torch/common/env.py" in by_msg


def test_edit_distance():
    assert edit_distance("HOROVOD_CYLE_TIME", "HOROVOD_CYCLE_TIME") == 1
    assert edit_distance("abc", "abc") == 0
    assert nearest_registered("HOROVOD_CYCLE_TIME") == \
        ("HOROVOD_CYCLE_TIME", 0)


def test_registry_declares_the_launch_contract():
    """The names the launcher, cluster_job and the elastic worker set."""
    for name in ("HOROVOD_CLUSTER_JOB", "HOROVOD_CLUSTER_ROUND",
                 "HOROVOD_CONTROLLER_DATA_PORT",
                 "HOROVOD_SMALL_TENSOR_ALGO"):
        assert name in REGISTRY, name
    assert all(n.startswith("HOROVOD_") for n in REGISTRY)


def _doc_with_table(tmp_path: Path, body: str) -> Path:
    p = tmp_path / "README.md"
    p.write_text(f"# doc\n\n{TABLE_BEGIN}\n{body}{TABLE_END}\n")
    return p


def test_env_table_renders_every_variable():
    rows = [r for r in render_env_table().splitlines()
            if r.startswith("| `")]
    assert [r.split("`")[1] for r in rows] == sorted(REGISTRY)
    assert "| `HOROVOD_CYCLE_TIME` | `1.0` |" in render_env_table()
    assert "| `HOROVOD_TUNE` | 0 |" in render_env_table()
    assert "| `HOROVOD_TIMELINE` | _(unset)_ |" in render_env_table()


def test_doc_sync_clean_and_stale(tmp_path):
    doc = _doc_with_table(tmp_path, render_env_table())
    rep = Reporter(tmp_path)
    check_doc_sync(rep, doc)
    assert rep.findings == []
    rows = render_env_table().splitlines()
    dropped = [r for r in rows if "HOROVOD_CYCLE_TIME" not in r]
    doc = _doc_with_table(tmp_path, "\n".join(dropped) + "\n")
    rep = Reporter(tmp_path)
    check_doc_sync(rep, doc)
    assert [f.rule for f in rep.findings] == ["HVL006"]
    assert "HOROVOD_CYCLE_TIME" in rep.findings[0].message


def test_write_env_table_roundtrip(tmp_path):
    doc = _doc_with_table(tmp_path, "| stale |\n")
    assert write_env_table(doc) is True
    rep = Reporter(tmp_path)
    check_doc_sync(rep, doc)
    assert rep.findings == []
    assert write_env_table(doc) is False  # idempotent
    assert lint_main(["--write-env-table", "--repo-root",
                      str(tmp_path)]) == 0


def test_readme_table_is_current():
    rep = Reporter(REPO)
    check_doc_sync(rep, REPO / "README.md")
    assert rep.findings == [], rep.findings[0].render()


# -- scan roots and rule table ---------------------------------------------

def test_default_roots_skip_lint_fixtures():
    files = iter_source_files([REPO / "tests"], (".py",),
                              extra_exclude_dirs=("*lint_fixtures",))
    assert not [f for f in files if "lint_fixtures" in f.parts[-2]]
    assert iter_source_files([FIXTURES], (".py",))


def test_rules_are_the_python_rules():
    """The Python rules, and HVL104 over the kernel ABI (the reference's
    HVL101-HVL103 read engine C++ the port does not have)."""
    assert sorted(RULES) == [f"HVL00{i}" for i in range(1, 9)] + ["HVL104"]


# -- HVL104: the kernel ABI ------------------------------------------------

@pytest.mark.parametrize("name,path,line,words", [
    ("unbound", "csrc/kern.cu", 14, "`hvd_kern_reset` is not bound"),
    ("arity", "_build.py", 8, "declare 6 parameter(s) but the C signature"),
    ("width", "flash_attention.py", 6, "(dtype 1, head_dim 256), which "
                                       "HVD_FLASH_DISPATCH lacks"),
    ("wide", "csrc/flash_common.cuh", 14, "instantiates (dtype 1, head_dim "
                                          "0), which _KERNEL_DTYPES"),
])
def test_hvl104_fires_on_each_drift(name, path, line, words):
    """An unbound export, a wrong arity, a width the dispatch lacks and a
    wide case the Python side lacks, each flagged at its line on the side
    that drifted."""
    fixture = FIXTURES / f"hvl104_{name}"
    findings, fired = rules_in(f"hvl104_{name}", rules={"HVL104"})
    assert fired == ["HVL104"]
    where = {(f.path, f.line) for f in findings}
    assert where == {((fixture / path).relative_to(REPO).as_posix(), line)}
    assert any(words in f.message for f in findings), \
        [f.message for f in findings]


def test_hvl104_clean_fixture_and_the_port():
    """The clean fixture lints clean under every rule, and HVL104 finds
    nothing in the port, whose sides it does read: five bound exports,
    and eighteen dispatch cases (fifteen narrow, three wide) equal to the
    Python side's."""
    import ast
    from horovod_tpu_torch.lint import abi_rules
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    findings, _ = rules_in("hvl104_clean")
    assert findings == [], [f.render() for f in findings]
    assert run_lint(repo_root=REPO, rules={"HVL104"}) == []
    ops = REPO / "horovod_tpu_torch" / "ops"
    exports = {}
    for f in _build.SOURCES.values():
        exports.update(abi_rules.parse_exports((ops / "csrc" / f)
                                               .read_text()))
    assert set(exports) == set(_build.SIGNATURES)
    cases = abi_rules.parse_dispatch((ops / "csrc" / "flash_common.cuh")
                                     .read_text())
    assert set(cases) == {(c, w) for c in fa._KERNEL_DTYPES.values()
                          for w in fa._KERNEL_HEAD_DIMS + (fa._KERNEL_WIDE,)}
    assert len(cases) == 18
    _, signatures = abi_rules.parse_build(ast.parse(
        (ops / "_build.py").read_text()))
    assert {s: n for s, (_, n, _) in signatures.items()} == \
        {s: len(t) for s, (_, t) in _build.SIGNATURES.items()}


def test_hvl104_param_count():
    from horovod_tpu_torch.lint.abi_rules import param_count
    text = 'extern "C" int f(int a, void (*cb)(int, int), float b)'
    assert param_count(text, text.index("(")) == 3
    assert param_count("g(void)", 1) == 0 and param_count("g()", 1) == 0


# -- the gate: the port itself lints clean ---------------------------------

def test_port_lints_clean():
    findings = run_lint(repo_root=REPO)
    assert findings == [], "port lint found:\n" + "\n".join(
        f.render() for f in findings)


def test_port_has_no_file_level_suppression():
    from horovod_tpu_torch.lint.base import parse_suppressions
    for path in (REPO / "horovod_tpu_torch").rglob("*.py"):
        assert parse_suppressions(path.read_text()).file_rules is None, path
    assert parse_suppressions((FIXTURES / "file_suppressed.py")
                              .read_text()).file_rules == {"HVL004"}


# -- CLI exit codes ----------------------------------------------------------

def test_cli_exit_codes(capsys):
    assert lint_main(["--repo-root", str(REPO)]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert lint_main([str(FIXTURES / "hvl003_trigger.py")]) == 1
    assert "HVL003" in capsys.readouterr().out
    assert lint_main(["--rules", "HVL999"]) == 2
    assert lint_main(["--list-rules"]) == 0
    assert lint_main([str(FIXTURES / "hvl004_trigger.py"), "--json",
                      "--rules", "HVL004"]) == 1
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("["):])
    assert {f["rule"] for f in doc} == {"HVL004"} and len(doc) == 4
