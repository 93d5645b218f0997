"""reprolint for the port: static analysis of ``src/repro_torch``, the
counterpart of ``repro.analysis``.

Pass families:

  * concurrency (:mod:`.locks`) — LCK001..LCK004: guarded-by
    discipline, lock-order cycles, pin/release balance;
  * host syncs and cache keys (:mod:`.tracer`) — TRC003 (a host sync
    under a serving lock) and TRC004 (an executable-cache key that misses
    a closed-over value; builtins exempt);
  * kernel launches (:mod:`.launches`) — KRN001: every C entry reached
    through ``kernels._build.function`` (the int guard) and its return
    code through ``kernels._build.check``; with ``strict=True`` on the
    card, KRN002: every entry launched once through its guard;
  * span hygiene (:mod:`.telemetry_lint`) — TEL001; SUP001 rides in
    :mod:`.findings`.

The reference's TRC001 / TRC002 (tracers, Pallas kernel captures) and
PLK001..PLK003 (VMEM, index maps, clamped indexing) have no counterpart:
the port has no tracers, no Pallas and no kernel bodies in Python.

The default run is stdlib-only (pure ``ast``); it imports neither torch
nor the kernels. The CLI lives in ``__main__`` (``python -m
repro_torch.analysis``); the runtime smoke lane in :mod:`.smoke`.
"""
from __future__ import annotations

import os

from . import launches, locks, telemetry_lint, tracer
from .astutil import SourceFile, load
from .findings import RULES, Finding, apply_suppressions

__all__ = ["analyze", "collect_files", "DEFAULT_ROOTS", "RULES", "Finding"]

_PKG = os.path.dirname(os.path.abspath(__file__))
#: default analysis root: the repro_torch package itself
DEFAULT_ROOTS = (os.path.dirname(_PKG),)

#: path fragments never analyzed (known-bad rule fixtures exist to
#: contain violations)
EXCLUDED_PARTS = ("analysis_fixtures", "torch_analysis_fixtures",
                  "__pycache__")


def collect_files(paths=None) -> list:
    """Expand files/directories into the list of .py files to lint. The
    EXCLUDED_PARTS filter applies only to directory walks — a file named
    explicitly is always linted (how the fixture tests target known-bad
    snippets)."""
    out: list = []
    for root in (paths or DEFAULT_ROOTS):
        if os.path.isfile(root):
            out.append(root)
            continue
        if not os.path.isdir(root):
            raise FileNotFoundError(f"no such file or directory: {root}")
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in EXCLUDED_PARTS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def analyze(paths=None, *, strict: bool = False) -> list:
    """Run every applicable pass; return Findings sorted by (path, line).

    Findings covered by a justified ``# reprolint: disable=`` come back
    with ``suppressed=True`` (the CLI prints but does not fail on them);
    an unjustified disable surfaces as a live SUP001. ``strict=True`` adds
    KRN002, which needs a CUDA device (RuntimeError without one).
    """
    files: list[SourceFile] = [load(p) for p in collect_files(paths)]
    findings: list[Finding] = []
    findings += locks.run(files)
    findings += tracer.run(files)
    findings += launches.run(files)
    findings += telemetry_lint.run(files)
    if strict:
        findings += launches.strict()
    directives = {src.path: src.directives for src in files}
    findings = apply_suppressions(findings, directives)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
