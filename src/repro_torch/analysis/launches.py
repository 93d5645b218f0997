"""Kernel-launch discipline (KRN001, KRN002): the port's counterpart of
``repro.analysis.pallas_static`` / ``pallas_trace``.

The reference's PLK rules read Pallas kernel bodies and their specs: a
VMEM budget (PLK001), race-free output ``index_map`` s (PLK002) and
clamped dynamic indexing (PLK003). None carries over: a CUDA kernel has
no VMEM, no BlockSpec and no ``index_map``, and its body is C++. What
holds a launch's bounds in the port is ``REPRO_SANITIZE`` (the output
contracts, ``kernels.sanitize``; run by ``--sanitize-smoke``) and the int
guard of ``kernels._build.function``, which refuses a size its ctypes
type would wrap. These rules make sure every launch goes through that
guard and through the error check:

KRN001 (static, every run) flags

  * a C library loaded, or a raw C entry reached, other than through
    ``_build.function``: ``ctypes.CDLL(...)``, ``ctypes.cdll``,
    ``LoadLibrary``, ``ctypes.PyDLL``, or ``_build._library`` (whose
    attributes are the unguarded entries);
  * a call of an entry that ``_build.function`` returned whose return
    code is not assigned to a name that then reaches ``_build.check`` in
    the same function.

``kernels/_build.py`` itself is exempt: it is where the guard lives.

KRN002 (``--strict``, on the card) builds the kernels, drives every
wrapper once through :mod:`.smoke`, and then checks each C entry named
in ``src/repro_torch/kernels/`` was launched through its guard, and that
the guard refuses 2^31 in each of its int arguments (``check_args``:
nothing is launched for that).
"""
from __future__ import annotations

import ast
import os

from .astutil import SourceFile, call_name, load
from .findings import Finding

__all__ = ["run", "c_entries", "strict"]

_RAW_LOADERS = {"CDLL", "PyDLL", "LoadLibrary", "cdll", "pydll",
                "_library"}

_KERNELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels")


def _is_build_function(call: ast.AST) -> bool:
    return isinstance(call, ast.Call) and (
        call_name(call.func) in ("_build.function", "function")
        or call_name(call.func).endswith("._build.function"))


def _is_check(call: ast.Call) -> bool:
    name = call_name(call.func)
    return name in ("_build.check", "check") \
        or name.endswith("._build.check")


def _exempt(src: SourceFile) -> bool:
    return src.path.replace("\\", "/").endswith("kernels/_build.py")


def _check_raw(src: SourceFile) -> list:
    out = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Attribute) and node.attr in _RAW_LOADERS \
                and call_name(node) != "":
            base = call_name(node.value)
            if node.attr == "_library" and not base.endswith("_build"):
                continue
            out.append(Finding(
                "KRN001", src.path, node.lineno,
                f"C library reached through {call_name(node)!r}: its "
                "entries skip the int guard of _build.function",
                hint="load entries with kernels._build.function(lib, fn, "
                     "argtypes)"))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("CDLL", "PyDLL"):
            out.append(Finding(
                "KRN001", src.path, node.lineno,
                f"C library loaded with {node.func.id}(...): its entries "
                "skip the int guard of _build.function",
                hint="load entries with kernels._build.function(lib, fn, "
                     "argtypes)"))
    return out


def _check_codes(src: SourceFile) -> list:
    """Every call of a guarded entry must hand its code to _build.check."""
    out = []
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        entries = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_build_function(
                    node.value):
                entries |= {t.id for t in node.targets
                            if isinstance(t, ast.Name)}
        checked = {a.id for node in ast.walk(fn)
                   if isinstance(node, ast.Call) and _is_check(node)
                   for a in node.args if isinstance(a, ast.Name)}
        assigned = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                assigned[id(node.value)] = [t.id for t in node.targets
                                            if isinstance(t, ast.Name)]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            launch = (isinstance(node.func, ast.Name)
                      and node.func.id in entries) \
                or _is_build_function(node.func)
            if not launch:
                continue
            names = assigned.get(id(node), [])
            if not any(n in checked for n in names):
                out.append(Finding(
                    "KRN001", src.path, node.lineno,
                    "the return code of a C entry never reaches "
                    "_build.check",
                    hint="err = fn(...); _build.check(lib, err, what)"))
    return out


def run(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if _exempt(src):
            continue
        seen = set()
        for f in _check_raw(src) + _check_codes(src):
            if (f.line, f.message) not in seen:     # one per line and fault
                seen.add((f.line, f.message))
                findings.append(f)
    return findings


def c_entries(kernels_dir: str = _KERNELS) -> list:
    """[(lib, fn, path, line)] of every ``_build.function("lib", "fn",
    ...)`` call with literal names in the kernel wrappers."""
    out = []
    for name in sorted(os.listdir(kernels_dir)):
        if not name.endswith(".py") or name == "_build.py":
            continue
        src = load(os.path.join(kernels_dir, name))
        for node in ast.walk(src.tree):
            if _is_build_function(node) and len(node.args) >= 2 and all(
                    isinstance(a, ast.Constant) and isinstance(a.value, str)
                    for a in node.args[:2]):
                out.append((node.args[0].value, node.args[1].value,
                            src.path, node.lineno))
    return sorted(set(out), key=lambda e: (e[0], e[1]))


def strict(echo=print) -> list[Finding]:
    """KRN002 on the card: drive every wrapper once (the sanitize smoke
    on CUDA tensors), then check each C entry of the kernels went through
    its guard and that the guard refuses an int argument of 2^31. Raises
    RuntimeError without a card."""
    import torch

    from ..kernels import _build
    from . import smoke
    if not torch.cuda.is_available():
        raise RuntimeError("--strict runs the guard over one launch of each "
                           "kernel, and needs a CUDA device")
    _build.build_all()
    for entry in _build.entries().values():
        entry.calls = 0                 # this run's launches only
    smoke.run(device="cuda", echo=echo)
    torch.cuda.synchronize()
    loaded = _build.entries()
    findings = []
    for lib, fn, path, line in c_entries():
        entry = loaded.get((lib, fn))
        if entry is None or entry.calls == 0:
            findings.append(Finding(
                "KRN002", path, line,
                f"{lib}.{fn} was not launched through its guard by the "
                "strict run", hint="drive it in analysis.smoke"))
            continue
        ints = [i for i, _, hi in entry.int_args if hi < (1 << 31)]
        base = [0] * len(entry.argtypes)
        for i, lo, hi in entry.int_args:     # every other int in range
            base[i] = min(max(0, lo), hi)
        for i in ints:
            args = list(base)
            args[i] = 1 << 31
            try:
                entry.check_args(args)
            except OverflowError:
                continue
            findings.append(Finding(
                "KRN002", path, line,
                f"the guard of {lib}.{fn} let 2^31 through in argument {i}",
                hint="kernels._build.Entry.check_args"))
        echo(f"  guard ok     {lib}.{fn}: {entry.calls} launch(es), "
             f"{len(ints)} int argument(s) refuse 2^31")
    return findings
