"""Python prong: collective-safety rules (HVL001-HVL003), stdlib ``ast``.

Counterpart of ``horovod_tpu/lint/py_collectives.py`` over the port's
collective surface. The contract is Horovod's (arXiv:1802.05799): every
rank submits the same collectives in a compatible order. NCCL and gloo
have no signature check: a violation hangs the job at the group timeout,
or, when the shapes happen to agree, reduces the wrong tensors. These
rules catch the shapes of code that produce violations at authoring
time:

- HVL001 — a collective reachable only when a rank-dependent condition
  holds (``if dist.get_rank() == 0: dist.all_reduce(...)``), including
  the early-return form (``if hvd.rank() != 0: return`` followed by
  collectives).
- HVL002 — an ``if/else`` on a rank-dependent condition whose branches
  issue *different* collective sequences.
- HVL003 — a broad ``except Exception``/bare ``except`` wrapping
  collective calls without re-raising: it can eat ``HorovodInternalError``
  or ``torch.distributed``'s ``DistBackendError``, and fast abort and
  ``elastic.run``'s recovery depend on those reaching every rank's retry
  loop. An earlier handler of the same ``try`` that catches one of them
  and re-raises routes it out first, and clears the broad one.
"""

from __future__ import annotations

import ast
from pathlib import Path

from horovod_tpu_torch.lint.base import FileReporter, Reporter

# The port's collective surface: the reference's names that mpi_ops,
# functions, parallel/collectives and common/eager still use, the
# torch.distributed calls the port issues, the group constructors every
# rank must call, and ppermute. Point-to-point calls (send, recv, isend,
# irecv) are deliberately absent, as `join` is: a subset of ranks calls
# them by design, so rank-dependent reachability is their job.
COLLECTIVE_NAMES = frozenset({
    # the reference's surface, as the port keeps it
    "allreduce", "allreduce_async",
    "allgather", "allgather_async", "allgather_object",
    "broadcast", "broadcast_async",
    "broadcast_object", "broadcast_parameters",
    "broadcast_optimizer_state",
    "alltoall", "alltoall_async",
    "reducescatter",
    "grouped_allreduce", "grouped_allreduce_async",
    "hierarchical_allreduce",
    "quantized_allreduce", "quantized_allgather",
    "quantized_reducescatter",
    "barrier",
    # completion of an async collective — where HorovodInternalError
    # actually surfaces on the eager path
    "synchronize",
    # torch.distributed
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter_tensor", "all_to_all_single",
    "batch_isend_irecv", "broadcast_object_list", "monitored_barrier",
    # group constructors: collective over the world group
    "new_group", "new_subgroups_by_enumeration",
    # the ring step of parallel/collectives (its autograd Function)
    "ppermute",
})

# Condition fragments that make a branch rank-dependent.
_RANK_CALL_NAMES = frozenset({"rank", "local_rank", "cross_rank",
                              "axis_rank", "process_index", "get_rank"})
_RANK_VALUE_NAMES = frozenset({"rank", "local_rank", "cross_rank",
                               "is_coordinator", "is_chief", "is_root",
                               "is_master", "root_rank"})

_BROAD_EXC_NAMES = frozenset({"Exception", "BaseException"})
# what a broad handler can swallow: the port's abort error and the
# backend's, which basics.translate_failures turns into it
_ABORT_EXC_NAMES = frozenset({"HorovodInternalError", "DistBackendError"})


def _call_name(node: ast.Call):
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_rank_dependent(test: ast.AST) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Call) and _call_name(node) in _RANK_CALL_NAMES:
            return True
        if isinstance(node, ast.Attribute) and \
                node.attr in _RANK_VALUE_NAMES:
            return True
        if isinstance(node, ast.Name) and node.id in _RANK_VALUE_NAMES:
            return True
    return False


def _collective_calls(node: ast.AST):
    """Collective Call nodes anywhere under ``node`` (skipping nested
    function/class definitions — their reachability is their own)."""
    out = []

    def visit(n):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return
        if isinstance(n, ast.Call) and _call_name(n) in COLLECTIVE_NAMES:
            out.append(n)
        for child in ast.iter_child_nodes(n):
            visit(child)

    for child in ast.iter_child_nodes(node) if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)) else [node]:
        visit(child)
    return out


def _collective_calls_in_stmts(stmts) -> list:
    out = []
    for s in stmts:
        out.extend(_collective_calls(s))
    return out


def _terminates(stmts) -> bool:
    """Does the block unconditionally leave the enclosing flow?"""
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _handler_names(handler: ast.ExceptHandler) -> list:
    t = handler.type
    names = []
    for node in ([t] if not isinstance(t, ast.Tuple) else t.elts):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
    return names


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    return any(n in _BROAD_EXC_NAMES for n in _handler_names(handler))


def _reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
    return False


class _Checker(ast.NodeVisitor):
    def __init__(self, rep: FileReporter):
        self.rep = rep

    # -- rank-divergent reachability (HVL001/HVL002) --------------------

    def _flag_collectives(self, stmts, why: str):
        for call in _collective_calls_in_stmts(stmts):
            self.rep.add(
                "HVL001", call.lineno,
                f"collective `{_call_name(call)}` is {why} — every rank "
                "must submit the same collectives in the same order "
                "(runtime analog: the coordinator's signature-hash desync "
                "error)")

    def visit_If(self, node: ast.If):
        if not _is_rank_dependent(node.test):
            self.generic_visit(node)
            return
        body_seq = [_call_name(c)
                    for c in _collective_calls_in_stmts(node.body)]
        else_seq = [_call_name(c)
                    for c in _collective_calls_in_stmts(node.orelse)]
        if body_seq and else_seq and body_seq != else_seq:
            self.rep.add(
                "HVL002", node.lineno,
                "rank-dependent if/else issues different collective "
                f"sequences: {body_seq} vs {else_seq} — ranks taking "
                "different branches desynchronize the collective order")
        elif body_seq != else_seq:
            # one-sided: collectives only on one branch
            side = node.body if body_seq else node.orelse
            self._flag_collectives(
                side, "reachable only under a rank-dependent condition")
        # still descend: nested Try/If structure has its own rules; exact
        # duplicates are collapsed by the caller's dedupe
        self.generic_visit(node)

    def visit_While(self, node: ast.While):
        if _is_rank_dependent(node.test):
            self._flag_collectives(
                node.body,
                "looped under a rank-dependent `while` condition")
        self.generic_visit(node)

    def _check_early_exit(self, stmts):
        """``if rank() != 0: return`` (or raise/continue/break) makes every
        later collective in the block rank-divergent."""
        divergent_since = None
        for stmt in stmts:
            if divergent_since is not None:
                for call in _collective_calls(stmt):
                    self.rep.add(
                        "HVL001", call.lineno,
                        f"collective `{_call_name(call)}` follows a "
                        "rank-dependent early exit at line "
                        f"{divergent_since} — only a subset of ranks "
                        "reaches it")
            elif isinstance(stmt, ast.If) and \
                    _is_rank_dependent(stmt.test) and \
                    _terminates(stmt.body) and not stmt.orelse:
                divergent_since = stmt.lineno

    def visit_FunctionDef(self, node):
        self._check_early_exit(node.body)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- swallowed abort (HVL003) ---------------------------------------

    def visit_Try(self, node: ast.Try):
        body_collectives = _collective_calls_in_stmts(node.body)
        if body_collectives:
            routed: set = set()  # abort errors an earlier handler re-raises
            for handler in node.handlers:
                if handler.type is not None and _reraises(handler):
                    routed |= _ABORT_EXC_NAMES & set(
                        _handler_names(handler))
                if _is_broad_handler(handler) and \
                        not _reraises(handler) and \
                        routed != _ABORT_EXC_NAMES:
                    names = sorted({_call_name(c)
                                    for c in body_collectives})
                    self.rep.add(
                        "HVL003", handler.lineno,
                        "broad except around collective call(s) "
                        f"{names} neither re-raises nor narrows: it can "
                        "swallow HorovodInternalError or DistBackendError "
                        "and strand the other ranks (fast abort and "
                        "elastic recovery depend on them propagating)")
        self.generic_visit(node)


def check_python_collectives(rep: Reporter, path: Path):
    fr = rep.scan_file(path)
    try:
        tree = ast.parse(fr.text, filename=str(path))
    except SyntaxError as e:
        fr.add("HVL001", e.lineno or 1, f"file does not parse: {e.msg}")
        return
    _Checker(fr).visit(tree)
