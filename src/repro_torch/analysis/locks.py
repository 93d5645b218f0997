"""Concurrency passes: lock discipline, lock ordering, pin/release balance
(``repro.analysis.locks``, unchanged in meaning).

LCK001 — guarded-by. A class opts in with a literal class attribute

    _REPROLINT_GUARDED_BY = {"_live": "_lock", "_stats": "_cv"}

mapping instance attributes to the lock/condition attribute that guards
them. Every ``self.<attr>`` read or write of a guarded attribute must then
sit lexically inside ``with self.<lock>:`` (nested functions do NOT
inherit the held set — a closure runs later, possibly on another thread,
which is exactly how the engine's trace counter escaped its lock).
Methods that are only ever called with the lock held declare it:

    def _trim(self, name):  # reprolint: holds=_lock

``__init__`` is exempt (the object is not shared yet).

LCK002 — lock order. Builds the acquisition graph: an edge L -> M when M
is acquired (lexically, or by a resolvable method call) while L is held.
Any cycle is a deadlock hazard. Calls are resolved one level deep:
``self.m()`` to the same class, ``self.attr.m()`` through constructor
assignments / parameter annotations naming an analyzed class.

LCK003 — pin balance. Every ``var = <obj>.pin(...)`` must be immediately
followed by a ``try:`` whose ``finally:`` calls ``<obj>.release(var)``
(the assignment may itself be the tail of a try whose handlers all
return/raise — the pipeline's KeyError-shaped pin). ``with x.pinned(...)``
needs nothing: the context manager owns the balance.
"""
from __future__ import annotations

import ast

from .astutil import (SourceFile, call_name, dict_literal,
                      lock_attrs_of_class)
from .findings import Finding

__all__ = ["run"]

GUARDED_DECL = "_REPROLINT_GUARDED_BY"


def run(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    classes = _collect_classes(files)
    for info in classes.values():
        findings += _check_guarded(info)
        findings += _check_pins(info.src, info.node)
    findings += _check_pins_module_level(files, classes)
    findings += _check_lock_order(classes)
    return findings


class _ClassInfo:
    def __init__(self, src: SourceFile, node: ast.ClassDef):
        self.src = src
        self.node = node
        self.locks = lock_attrs_of_class(node)
        self.guarded = {}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == GUARDED_DECL
                    for t in stmt.targets):
                self.guarded = dict_literal(stmt.value) or {}
                self.decl_line = stmt.lineno
        self.locks |= set(self.guarded.values())
        self.methods = {s.name: s for s in node.body
                        if isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        self.attr_classes = _attr_class_candidates(node)


def _collect_classes(files) -> dict:
    out = {}
    for src in files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                out[node.name] = _ClassInfo(src, node)
    return out


def _attr_class_candidates(cls: ast.ClassDef) -> dict:
    """self.<attr> -> {possible class names}, from __init__ constructor
    calls (self.store = IndexStore(...)), plain param forwarding
    (self.store = store) through the param's annotation, and annotations."""
    out: dict = {}
    init = next((s for s in cls.body
                 if isinstance(s, ast.FunctionDef) and s.name == "__init__"),
                None)
    if init is None:
        return out
    ann_of_param = {}
    for p in init.args.args + init.args.kwonlyargs:
        if p.annotation is not None:
            ann_of_param[p.arg] = _annotation_names(p.annotation)
    for node in ast.walk(init):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            names = set()
            if isinstance(node.value, ast.Call):
                names.add(call_name(node.value.func).rsplit(".", 1)[-1])
            elif isinstance(node.value, ast.Name):
                names |= ann_of_param.get(node.value.id, set())
            elif isinstance(node.value, ast.IfExp):
                for branch in (node.value.body, node.value.orelse):
                    if isinstance(branch, ast.Call):
                        names.add(call_name(branch.func).rsplit(".", 1)[-1])
                    elif isinstance(branch, ast.Name):
                        names |= ann_of_param.get(branch.id, set())
            if names:
                out.setdefault(tgt.attr, set()).update(names)
    return out


def _annotation_names(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# ---------------------------------------------------------------------------
# LCK001: guarded-by
# ---------------------------------------------------------------------------

def _with_locks(node: ast.With, locks: set) -> list:
    out = []
    for item in node.items:
        ce = item.context_expr
        if (isinstance(ce, ast.Attribute) and isinstance(ce.value, ast.Name)
                and ce.value.id == "self" and ce.attr in locks):
            out.append(ce.attr)
    return out


def _check_guarded(info: _ClassInfo) -> list:
    findings: list[Finding] = []
    if not info.guarded:
        return findings
    src = info.src

    known = set()
    for node in ast.walk(info.node):
        if (isinstance(node, ast.Attribute) and isinstance(node.value,
                                                           ast.Name)
                and node.value.id == "self"):
            known.add(node.attr)
    for attr, lock in info.guarded.items():
        if attr not in known or lock not in info.locks:
            findings.append(Finding(
                "LCK004", src.path, getattr(info, "decl_line", 1),
                f"{info.node.name}.{GUARDED_DECL} maps {attr!r} -> {lock!r} "
                "but that attribute/lock is never used by the class",
                hint="fix the declaration or delete the stale entry"))

    reported = set()

    def flag(sub, held, fname):
        lock = info.guarded[sub.attr]
        if lock not in held and (sub.lineno, sub.attr) not in reported:
            reported.add((sub.lineno, sub.attr))
            findings.append(Finding(
                "LCK001", src.path, sub.lineno,
                f"{info.node.name}.{sub.attr} accessed in {fname} "
                f"without holding self.{lock}",
                hint=f"wrap in `with self.{lock}:` or annotate the "
                     f"method `# reprolint: holds={lock}`"))

    def visit(node, held, fname):
        """Walk preserving lexical lock scope: with-bodies extend the held
        set; nested defs/lambdas reset it (a closure runs later, possibly
        on another thread)."""
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = _with_locks(node, info.locks)
            for item in node.items:
                visit(item.context_expr, held, fname)
            for stmt in node.body:
                visit(stmt, held | set(acquired), fname)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            h0 = src.holds_for_line(node.lineno)
            for stmt in node.body:
                visit(stmt, h0, f"{fname}.{node.name}")
            return
        if isinstance(node, ast.Lambda):
            visit(node.body, set(), fname)
            return
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self" and node.attr in info.guarded):
            flag(node, held, fname)
        for child in ast.iter_child_nodes(node):
            visit(child, held, fname)

    for name, meth in info.methods.items():
        if name == "__init__":
            continue
        held0 = src.holds_for_line(meth.lineno)
        for stmt in meth.body:
            visit(stmt, held0, f"{info.node.name}.{name}")
    return findings


# ---------------------------------------------------------------------------
# LCK002: lock-order cycles
# ---------------------------------------------------------------------------

def _check_lock_order(classes: dict) -> list:
    # per-method: lexically acquired locks + calls made (held, callee)
    acquires: dict = {}           # (cls, meth) -> set[(cls, lock)]
    calls: dict = {}              # (cls, meth) -> list[(heldset, callee)]
    edges: dict = {}              # (lockA, lockB) -> example site

    for cname, info in classes.items():
        for mname, meth in info.methods.items():
            key = (cname, mname)
            acquires[key] = set()
            calls[key] = []

            def visit(node, held, key=key, info=info, cname=cname):
                if isinstance(node, ast.With):
                    got = [(cname, a) for a in _with_locks(node, info.locks)]
                    for g in got:
                        acquires[key].add(g)
                        for h in held:
                            if h != g:
                                edges.setdefault(
                                    (h, g), (info.src.path, node.lineno))
                    for stmt in node.body:
                        visit(stmt, held + got)
                    return
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    # closures run later — the held set does not transfer
                    held = []
                if isinstance(node, ast.Call):
                    callee = _resolve_call(node, cname, info, classes)
                    if callee is not None:
                        calls[key].append((tuple(held), callee))
                for child in ast.iter_child_nodes(node):
                    visit(child, held)

            held0 = [(cname, h)
                     for h in info.src.holds_for_line(meth.lineno)]
            for stmt in meth.body:
                visit(stmt, held0)

    # transitive closure of acquired sets through resolvable calls
    changed = True
    while changed:
        changed = False
        for key, callees in calls.items():
            for _, callee in callees:
                extra = acquires.get(callee, set()) - acquires[key]
                if extra:
                    acquires[key] |= extra
                    changed = True
    # call-mediated edges
    for key, callees in calls.items():
        cname, mname = key
        info = classes[cname]
        for held, callee in callees:
            for h in held:
                for g in acquires.get(callee, ()):
                    if h != g:
                        edges.setdefault((h, g), (info.src.path,
                                                  info.methods[mname].lineno))

    return _find_cycles(edges)


def _resolve_call(node: ast.Call, cname: str, info, classes):
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    if isinstance(func.value, ast.Name) and func.value.id == "self":
        if func.attr in info.methods:
            return (cname, func.attr)
        return None
    if (isinstance(func.value, ast.Attribute)
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "self"):
        for cand in info.attr_classes.get(func.value.attr, ()):
            tgt = classes.get(cand)
            if tgt is not None and func.attr in tgt.methods:
                return (cand, func.attr)
    return None


def _find_cycles(edges: dict) -> list:
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    findings = []
    seen_cycles = set()
    for start in graph:
        stack, path = [(start, iter(graph.get(start, ())))], [start]
        on_path = {start}
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                stack.pop()
                path.pop()
                on_path.discard(node)
                continue
            if nxt in on_path:
                cyc = tuple(path[path.index(nxt):] + [nxt])
                canon = frozenset(cyc)
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    sitepath, siteline = edges.get(
                        (cyc[0], cyc[1]), edges.get((cyc[-2], cyc[-1])))
                    pretty = " -> ".join(f"{c}.{k}" for c, k in cyc)
                    findings.append(Finding(
                        "LCK002", sitepath, siteline,
                        f"lock acquisition cycle: {pretty}",
                        hint="pick one global order and acquire in it "
                             "everywhere (or drop to a single lock)"))
            elif nxt in graph:
                stack.append((nxt, iter(graph.get(nxt, ()))))
                path.append(nxt)
                on_path.add(nxt)
        if not stack:
            continue
    return findings


# ---------------------------------------------------------------------------
# LCK003: pin/release balance
# ---------------------------------------------------------------------------

def _is_pin_assign(stmt):
    if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == "pin"):
        return stmt.targets[0].id
    return None


def _releases(node, var: str) -> bool:
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "release" and sub.args
                and isinstance(sub.args[0], ast.Name)
                and sub.args[0].id == var):
            return True
    return False


def _handlers_terminal(handlers) -> bool:
    """Every except handler ends in return/raise/continue/break — control
    only reaches the next statement when the try body succeeded."""
    for h in handlers:
        if not h.body or not isinstance(
                h.body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)):
            return False
    return True


def _check_pins(src: SourceFile, root) -> list:
    findings: list[Finding] = []
    checked: set = set()

    def check_block(stmts):
        for i, stmt in enumerate(stmts):
            nxt = stmts[i + 1] if i + 1 < len(stmts) else None
            var = _is_pin_assign(stmt)
            if var is not None and id(stmt) not in checked:
                checked.add(id(stmt))
                ok = (isinstance(nxt, ast.Try)
                      and any(_releases(f, var) for f in nxt.finalbody))
                if not ok:
                    findings.append(Finding(
                        "LCK003", src.path, stmt.lineno,
                        f"pin() result {var!r} is not released on every "
                        "path",
                        hint="follow the pin with `try: ... finally: "
                             f"release({var})`, or use `with "
                             "store.pinned(...)`"))
            # a pin as the tail of a try whose handlers all bail out: the
            # release-try is the NEXT SIBLING of the enclosing Try
            if isinstance(stmt, ast.Try) and stmt.body:
                tail_var = _is_pin_assign(stmt.body[-1])
                if tail_var is not None and _handlers_terminal(stmt.handlers):
                    checked.add(id(stmt.body[-1]))
                    ok = (isinstance(nxt, ast.Try)
                          and any(_releases(f, tail_var)
                                  for f in nxt.finalbody))
                    if not ok:
                        findings.append(Finding(
                            "LCK003", src.path, stmt.body[-1].lineno,
                            f"pin() result {tail_var!r} is not released on "
                            "every path",
                            hint="follow the enclosing try with `try: ... "
                                 f"finally: release({tail_var})`"))
        for stmt in stmts:
            for field in ("body", "orelse", "finalbody"):
                inner = getattr(stmt, field, None)
                if inner and isinstance(inner, list) \
                        and all(isinstance(s, ast.stmt) for s in inner):
                    check_block(inner)
            for h in getattr(stmt, "handlers", []):
                check_block(h.body)

    for fn in [n for n in ast.walk(root)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        check_block(fn.body)
    return findings


def _check_pins_module_level(files, classes) -> list:
    """Pin balance for functions OUTSIDE any analyzed class — class bodies
    are already covered by the per-class _check_pins call."""
    findings = []
    class_nodes = {id(info.node) for info in classes.values()}
    for src in files:
        mod = ast.Module(body=[n for n in src.tree.body
                               if id(n) not in class_nodes],
                         type_ignores=[])
        findings += _check_pins(src, mod)
    return findings
