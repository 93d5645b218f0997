"""Host-sync and cache-key passes (TRC003, TRC004), the port's
counterparts of ``repro.analysis.tracer``.

The port has no tracers and no kernel bodies in Python: its kernels are
CUDA C++ behind ``kernels._build``, and a cache entry is a plain closure.
So TRC001 (control flow on tracers) and TRC002 (kernel closure captures)
have no counterpart here; the two rules that carry over keep their ids.

TRC003 flags a host synchronization made while holding a lock: a device
sync under a serving lock stalls every client behind it. For torch that
is ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.synchronize()``
(``torch.cuda.Event`` / ``Stream``), ``torch.cuda.synchronize`` and
``np.asarray`` / ``np.array`` (of a tensor: the pass cannot see the
type, so it flags every one, as the reference does).

TRC004 checks the executable-cache discipline: for a
``self._cached(key, make)`` call site, every name the entry's body
closes over must appear in the ``key`` expression, or two different
entries share one cache slot (stale results). Builtins (``len``,
``range``, ...) are exempt: they are not values an entry could differ
by, and the reference's pass, which does not exempt them, flags the
port's ``len(preds)`` as a missing key.
"""
from __future__ import annotations

import ast
import builtins

from .astutil import (SourceFile, assigned_names, call_name,
                      lock_attrs_of_class, module_level_names)
from .findings import Finding

__all__ = ["run"]

_HOST_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                    "numpy.array", "torch.cuda.synchronize"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}

#: names no cache key needs
_BUILTINS = frozenset(dir(builtins))


def _local_functions(scope) -> dict:
    out = {}
    for node in ast.walk(scope):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


# ---------------------------------------------------------------------------
# TRC003: host sync while holding a lock
# ---------------------------------------------------------------------------

def _is_host_sync(call: ast.Call) -> str | None:
    name = call_name(call.func)
    if name in _HOST_SYNC_CALLS:
        return name
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _HOST_SYNC_METHODS:
        return f".{call.func.attr}()"
    return None


def _check_host_sync(src: SourceFile) -> list:
    findings = []
    lock_attrs: set = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef):
            lock_attrs |= lock_attrs_of_class(node)

    def visit(node, held_depth):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acq = 0
            for item in node.items:
                ce = item.context_expr
                if (isinstance(ce, ast.Attribute)
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self" and ce.attr in lock_attrs):
                    acq = 1
            for stmt in node.body:
                visit(stmt, held_depth + acq)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for child in ast.iter_child_nodes(node):
                visit(child, 0)
            return
        if held_depth and isinstance(node, ast.Call):
            sync = _is_host_sync(node)
            if sync:
                findings.append(Finding(
                    "TRC003", src.path, node.lineno,
                    f"host sync {sync} while holding a serving lock",
                    hint="move the sync outside the `with` block; hold "
                         "locks only for bookkeeping"))
        for child in ast.iter_child_nodes(node):
            visit(child, held_depth)

    visit(src.tree, 0)
    return findings


# ---------------------------------------------------------------------------
# TRC004: cache keys must cover the entries' closures
# ---------------------------------------------------------------------------

def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _check_cache_keys(src: SourceFile) -> list:
    findings = []
    mod_names = set(module_level_names(src.tree))
    for fn in _local_functions(src.tree).values():
        cached_calls = [n for n in ast.walk(fn)
                        if isinstance(n, ast.Call)
                        and call_name(n.func).endswith("._cached")
                        and len(n.args) >= 2
                        and isinstance(n.args[0], ast.Name)
                        and isinstance(n.args[1], ast.Name)]
        if not cached_calls:
            continue
        # routing functions re-bind `make` per route: resolve each
        # _cached(key, make) call to the NEAREST preceding def of that name
        defs = sorted((n.lineno, n) for n in ast.walk(fn)
                      if isinstance(n, ast.FunctionDef) and n is not fn)
        key_names: dict = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                key_names.setdefault(node.targets[0].id, set()).update(
                    _names_in(node.value))
        for call in cached_calls:
            covered = key_names.get(call.args[0].id, set())
            make = None
            for line, node in defs:
                if node.name == call.args[1].id and line < call.lineno:
                    make = node
            if make is None:
                continue
            # the entry's body: the defs inside make
            bodies = [n for n in ast.walk(make)
                      if isinstance(n, ast.FunctionDef) and n is not make]
            for body in bodies:
                bound = assigned_names(body)
                for node in ast.walk(body):
                    if not (isinstance(node, ast.Name)
                            and isinstance(node.ctx, ast.Load)):
                        continue
                    name = node.id
                    if name in bound or name in mod_names \
                            or name in _BUILTINS or name == "self" \
                            or name in covered:
                        continue
                    covered.add(name)       # report once per name
                    findings.append(Finding(
                        "TRC004", src.path, node.lineno,
                        f"cached executable {body.name!r} closes over "
                        f"{name!r} which is missing from cache key "
                        f"{call.args[0].id!r}",
                        hint=f"add {name!r} to the key tuple (or derive it "
                             "inside the entry's body)"))
    return findings


def run(files: list) -> list:
    findings: list = []
    for src in files:
        findings += _check_host_sync(src)
        findings += _check_cache_keys(src)
    return findings
