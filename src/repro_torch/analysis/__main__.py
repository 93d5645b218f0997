"""``python -m repro_torch.analysis`` — the port's reprolint CLI.

Exit codes (the reference's contract):

  0  clean — no live findings (suppressed ones may print),
  1  findings — at least one live finding, or a smoke assertion failed,
  2  internal error — a pass crashed, or ``--strict`` found no CUDA
     device (it does not pass silently without one).
"""
from __future__ import annotations

import argparse
import sys
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint for the PyTorch port: lock discipline, host "
                    "syncs under locks, cache keys, kernel-launch guards "
                    "and span hygiene")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "repro_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="also launch every kernel once through its int "
                         "guard (KRN002; needs a CUDA device)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--sanitize-smoke", action="store_true",
                    help="run the REPRO_SANITIZE wrapper smoke (the twins "
                         "on the CPU) instead of the static passes")
    args = ap.parse_args(argv)

    if args.list_rules:
        from .findings import RULES
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    if args.sanitize_smoke:
        from . import smoke
        try:
            return smoke.run()
        except AssertionError as err:
            print(f"FAILED: {err}", file=sys.stderr)
            return 1
        except Exception:
            traceback.print_exc()
            return 2

    if args.strict:
        import torch
        if not torch.cuda.is_available():
            print("reprolint --strict launches every kernel once through its "
                  "guard and needs a CUDA device; none is available (exit 2)",
                  file=sys.stderr)
            return 2

    from . import analyze
    try:
        findings = analyze(args.paths or None, strict=args.strict)
    except AssertionError as err:
        print(f"FAILED: {err}", file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        print("reprolint: internal error (exit 2)", file=sys.stderr)
        return 2

    live = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    for f in findings:
        print(f.format())
    mode = "strict" if args.strict else "default"
    print(f"reprolint ({mode}): {len(live)} finding(s), "
          f"{len(suppressed)} suppressed")
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
