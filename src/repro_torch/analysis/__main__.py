"""CLI: ``python -m repro_torch.analysis [--json] [--baseline PATH]
[--root PATH] [--rule ID]``.

Exit codes: 0 = clean (no findings outside the baseline), 1 = findings,
2 = configuration error (not a repo root, malformed baseline, an entry
without a justification).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.engine import run_analysis
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analyzer for the PyTorch port's kernel, "
                    "determinism and no-fallback invariants.")
    parser.add_argument("--root", default=".",
                        help="repo root (contains src/repro_torch/); "
                             "default: cwd")
    parser.add_argument("--baseline", default=None,
                        help="baseline file of accepted, justified "
                             "exceptions (default: none)")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as JSON on stdout")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="ID", choices=sorted(RULES_BY_ID),
                        help="run only the given rule(s); repeatable")
    args = parser.parse_args(argv)

    root = Path(args.root)
    if not (root / "src" / "repro_torch").is_dir():
        print(f"error: {root} does not look like the repo root "
              "(no src/repro_torch/ directory)", file=sys.stderr)
        return 2
    rules = [RULES_BY_ID[r] for r in args.rule] if args.rule else None
    report = run_analysis(root, baseline_path=args.baseline, rules=rules)

    if args.json:
        json.dump(report.to_dict(), sys.stdout, indent=2)
        print()
    else:
        for f in report.unsuppressed:
            print(f.render())
        for key in report.stale_suppressions:
            print(f"warning: stale baseline entry (matches nothing): {key}",
                  file=sys.stderr)
        for e in report.errors:
            print(f"error: {e}", file=sys.stderr)
        n, s = len(report.unsuppressed), len(report.suppressed)
        print(f"repro_torch.analysis: {n} finding{'s' if n != 1 else ''}"
              + (f" ({s} baselined)" if s else "")
              + f" across {len(rules or ALL_RULES)} rules")
    if report.errors:
        return 2
    return 1 if report.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
