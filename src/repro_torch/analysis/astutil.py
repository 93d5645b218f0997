"""Shared AST plumbing for the port's reprolint passes, as
``repro.analysis.astutil``.

One :class:`SourceFile` per analyzed module: parsed tree, raw lines, and
the reprolint directives found in comments. Passes never re-read disk.
Everything here is stdlib-only: the default run imports neither torch
nor the kernel modules.
"""
from __future__ import annotations

import ast
import dataclasses

from .findings import Directive, parse_directives

__all__ = ["SourceFile", "load", "lock_attrs_of_class", "dict_literal",
           "call_name", "assigned_names", "free_loads", "iter_functions"]

#: threading constructors whose result makes an attribute "a lock" for the
#: discipline passes (Condition wraps a lock and is acquired the same way)
LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


@dataclasses.dataclass
class SourceFile:
    path: str
    text: str
    lines: list
    tree: ast.Module
    directives: list

    def holds_for_line(self, line: int) -> set:
        """Lock names a `# reprolint: holds=` directive declares held for a
        def whose header is on (or directly above) `line`."""
        out = set()
        for d in self.directives:
            if d.kind == "holds" and d.line in (line, line - 1):
                out.update(d.names)
        return out

    def directives_of(self, kind: str) -> list:
        return [d for d in self.directives if d.kind == kind]


def load(path: str) -> SourceFile:
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    return SourceFile(path=path, text=text, lines=text.splitlines(),
                      tree=ast.parse(text, filename=path),
                      directives=parse_directives(text.splitlines()))


def call_name(node: ast.AST) -> str:
    """Dotted name of a call target ('torch.cuda.synchronize',
    '_build.function', 'take')
    — empty string when the func is not a plain name/attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def lock_attrs_of_class(cls: ast.ClassDef) -> set:
    """Attributes assigned a threading.Lock/Condition/... anywhere in the
    class body (usually __init__): the lock vocabulary of the class."""
    locks = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = call_name(node.value.func).rsplit(".", 1)[-1]
            if ctor in LOCK_CTORS:
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        locks.add(tgt.attr)
    return locks


def dict_literal(node: ast.AST) -> dict | None:
    """{str: str} from an ast.Dict of constants, else None."""
    if not isinstance(node, ast.Dict):
        return None
    out = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(v, ast.Constant)):
            return None
        out[k.value] = v.value
    return out


def iter_functions(tree: ast.AST):
    """Yield every FunctionDef/AsyncFunctionDef in the tree (nested too)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def assigned_names(fn: ast.AST) -> set:
    """Names bound inside a function body: params, assignments, loop/with
    targets, comprehension vars, imports, nested def/class names."""
    names = set()
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            # own params AND nested-function/lambda params: a Load of such
            # a name inside `fn` is bound, not a closure capture
            a = sub.args
            for p in (list(a.posonlyargs) + list(a.args)
                      + list(a.kwonlyargs)):
                names.add(p.arg)
            if a.vararg:
                names.add(a.vararg.arg)
            if a.kwarg:
                names.add(a.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                     (ast.Store, ast.Del)):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)) and node is not fn:
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.ExceptHandler) and node.name:
            names.add(node.name)
    return names


def free_loads(fn: ast.AST) -> set:
    """Names read inside `fn` but not bound by it — closure/global refs."""
    bound = assigned_names(fn)
    free = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id not in bound:
            free.add(node.id)
    return free


def module_level_names(tree: ast.Module) -> dict:
    """name -> defining node for top-level defs/classes/imports/assigns."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = node
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = node
    return out
