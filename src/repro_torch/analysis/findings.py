"""Finding model + suppression directives for the port's reprolint, as
``repro.analysis.findings``.

Every pass emits :class:`Finding` records — (rule id, file, line, message,
fix hint) — instead of printing ad hoc; the CLI owns formatting and exit
codes. Suppressions are source comments:

    # reprolint: disable=LCK001 -- scheduler owns this map before start()

A ``disable`` applies to findings on its own line or the line directly
below it (so it can ride above a long statement). The justification text
after ``--`` is REQUIRED: a disable without one is itself a finding
(SUP001) — silencing a checker is a reviewed decision, not a shrug.

The rule ids are the reference's where the meaning carries over. TRC001,
TRC002 and PLK001-PLK003 have no counterpart (README, "Static analysis");
KRN001 and KRN002 are the port's own.
"""
from __future__ import annotations

import dataclasses
import re

__all__ = ["Finding", "Directive", "parse_directives", "apply_suppressions",
           "RULES"]

#: rule id -> one-line description (the catalog)
RULES = {
    "LCK001": "guarded attribute accessed without holding its declared lock",
    "LCK002": "lock acquisition graph contains a cycle (deadlock hazard)",
    "LCK003": "IndexStore-style pin() not released on every control-flow "
              "path (needs try/finally or the pinned() context manager)",
    "LCK004": "_REPROLINT_GUARDED_BY names an unknown attribute or lock",
    "TRC003": "host synchronization (.item/.tolist/.cpu/.numpy, "
              "np.asarray/np.array, torch.cuda.synchronize, "
              ".synchronize) while holding a serving lock",
    "TRC004": "cached executable closes over a value missing from its cache "
              "key (stale-entry hazard); builtins are exempt",
    "KRN001": "a C entry of the kernels reached other than through "
              "kernels._build.function (no int guard), or its return code "
              "never reaches kernels._build.check",
    "KRN002": "--strict on the card: a C entry not launched through the "
              "guard, or a guard that let an out-of-range size through",
    "TEL001": "telemetry span opened without a guaranteed close on "
              "exception paths (use `with span(...)` or try/finally)",
    "SUP001": "reprolint disable comment without a justification "
              "(use: # reprolint: disable=RULE -- why)",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False
    justification: str = ""

    def format(self) -> str:
        tail = f"  (fix: {self.hint})" if self.hint else ""
        sup = "  [suppressed]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tail}{sup}"


@dataclasses.dataclass(frozen=True)
class Directive:
    kind: str            # "disable" | "holds"
    names: tuple         # rule ids / lock attribute names
    line: int
    justification: str = ""


_DIRECTIVE_RE = re.compile(
    r"#\s*reprolint:\s*(disable|holds)\s*=\s*([A-Za-z0-9_,\s]+?)"
    r"(?:\s*--\s*(.*?))?\s*$")


def parse_directives(lines: list[str]) -> list[Directive]:
    out = []
    for i, text in enumerate(lines, start=1):
        m = _DIRECTIVE_RE.search(text)
        if m:
            names = tuple(n.strip() for n in m.group(2).split(",") if n.strip())
            out.append(Directive(kind=m.group(1), names=names, line=i,
                                 justification=(m.group(3) or "").strip()))
    return out


def apply_suppressions(findings: list[Finding],
                       directives_by_path: dict) -> list[Finding]:
    """Mark findings matched by a disable directive as suppressed, and emit
    SUP001 for directives lacking justification text. A directive on line L
    covers findings on L and L+1."""
    out: list[Finding] = []
    for f in findings:
        matched = None
        for d in directives_by_path.get(f.path, ()):
            if d.kind == "disable" and f.rule in d.names \
                    and f.line in (d.line, d.line + 1):
                matched = d
                break
        if matched is None:
            out.append(f)
        else:
            out.append(dataclasses.replace(
                f, suppressed=True, justification=matched.justification))
    for path, directives in directives_by_path.items():
        for d in directives:
            if d.kind == "disable" and not d.justification:
                out.append(Finding(
                    "SUP001", path, d.line,
                    "disable directive without justification",
                    hint="append `-- <why this is safe>` to the comment"))
    return out
