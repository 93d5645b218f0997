"""TEL001 — span hygiene, as ``repro.analysis.telemetry_lint``.

A telemetry span only records itself when its context manager exits; a
span that is opened but not closed on an exception path silently
vanishes from the trace — the worst possible failure mode for the tool
you reach for *during* incidents. The safe spellings are:

    with span("name"):                        # closed by construction
        ...

    sp = tracer.span("name")                  # assignment is fine IF the
    with sp:                                  # very next statement enters
        out = sp.fence(fn())                  # it (the engine's pattern)

Flagged:

  * ``x = <anything>.span(...)`` / ``x = span(...)`` where the next
    statement neither enters ``x`` in a ``with`` nor is a ``try`` whose
    ``finally`` closes it (``x.__exit__(...)`` / ``x.close()``);
  * ``self.sp = span(...)`` — storing an open span for a later manual
    close cannot be verified statically (suppress with a justified
    directive if truly needed);
  * a bare ``span(...)`` expression statement — the span context is
    created and dropped without ever being entered, so nothing records.

``tracer.add_span`` is exempt: it records a completed interval in one
call and has nothing to close. The checker matches on the method NAME
``span`` — if an unrelated ``.span()`` API enters the codebase, a
``# reprolint: disable=TEL001 -- <why>`` rides on that line.
"""
from __future__ import annotations

import ast

from .astutil import SourceFile
from .findings import Finding

__all__ = ["run"]


def _is_span_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    return (isinstance(f, ast.Name) and f.id == "span") or \
        (isinstance(f, ast.Attribute) and f.attr == "span")


def _span_assign_target(stmt):
    """(kind, name) for ``<target> = <...>.span(...)``: kind "name" for a
    plain variable, "attr" for an attribute target; None otherwise."""
    if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and _is_span_call(stmt.value)):
        return None
    tgt = stmt.targets[0]
    if isinstance(tgt, ast.Name):
        return ("name", tgt.id)
    if isinstance(tgt, ast.Attribute):
        return ("attr", ast.unparse(tgt))
    return None


def _enters(with_stmt, var: str) -> bool:
    return isinstance(with_stmt, (ast.With, ast.AsyncWith)) and any(
        isinstance(item.context_expr, ast.Name)
        and item.context_expr.id == var
        for item in with_stmt.items)


def _closes(node, var: str) -> bool:
    """Does this (finalbody) subtree call var.__exit__/close/end?"""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("__exit__", "close", "end")
                and isinstance(sub.func.value, ast.Name)
                and sub.func.value.id == var):
            return True
    return False


def _check_block(src: SourceFile, stmts, findings):
    for i, stmt in enumerate(stmts):
        nxt = stmts[i + 1] if i + 1 < len(stmts) else None
        tgt = _span_assign_target(stmt)
        if tgt is not None:
            kind, var = tgt
            if kind == "attr":
                findings.append(Finding(
                    "TEL001", src.path, stmt.lineno,
                    f"span stored into {var!r} — a later manual close "
                    "cannot be verified on exception paths",
                    hint="open the span with `with` at the use site"))
            else:
                ok = _enters(nxt, var) or (
                    isinstance(nxt, ast.Try)
                    and any(_closes(f, var) for f in nxt.finalbody))
                if not ok:
                    findings.append(Finding(
                        "TEL001", src.path, stmt.lineno,
                        f"span {var!r} opened without a guaranteed close "
                        "on exception paths",
                        hint=f"follow the assignment with `with {var}:` "
                             "or `try: ... finally: "
                             f"{var}.__exit__(None, None, None)`"))
        elif isinstance(stmt, ast.Expr) and _is_span_call(stmt.value):
            findings.append(Finding(
                "TEL001", src.path, stmt.lineno,
                "bare span(...) call: the span is never entered, so "
                "nothing is recorded",
                hint="use `with span(...):` around the timed region"))
    # recurse into every nested statement block
    for stmt in stmts:
        for field in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, field, None)
            if inner and isinstance(inner, list) \
                    and all(isinstance(s, ast.stmt) for s in inner):
                _check_block(src, inner, findings)
        for h in getattr(stmt, "handlers", []):
            _check_block(src, h.body, findings)


def run(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        # the tracer's own implementation builds span objects internally
        if src.path.replace("\\", "/").endswith(
                "repro_torch/telemetry/tracer.py"):
            continue
        _check_block(src, src.tree.body, findings)
    return findings
