"""CLI over exported cost ledgers and calibration cubes.

    python -m repro_torch.obs report LEDGER.jsonl            totals + economics
    python -m repro_torch.obs diff A.jsonl B.jsonl           regression compare
    python -m repro_torch.obs top A.jsonl [B.jsonl]          top spend (movers)
    python -m repro_torch.obs calib C.jsonl [B.jsonl]        coverage vs nominal

``diff``/``top`` exit 1 when ``--fail-above`` is set and the largest
per-cell spend delta exceeds it — the CI reconciliation/drift gate.
``calib`` gates on coverage drift instead: with one cube,
``--fail-above`` bounds max |empirical - nominal| coverage; with two,
the max per-fractile |coverage delta| between them.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.calibration import CalibrationCube
from repro_torch.obs.ledger import CostLedger


def _load(path: str) -> CostLedger:
    return CostLedger.from_jsonl(path)


def cmd_report(args) -> int:
    led = _load(args.ledger)
    print(f"ledger {args.ledger}: weeks {int(led.weeks[0])}.."
          f"{int(led.weeks[-1])}, {len(led.entities)} entities, "
          f"{len(led.sources)} sources")
    if led.meta:
        keys = ("policy", "cadence_weeks", "start_weeks", "horizon_weeks")
        line = ", ".join(
            f"{k}={led.meta[k]}" for k in keys if k in led.meta
        )
        if line:
            print(f"  {line}")
    print("\nspend by source:")
    for s, v in sorted(led.by_source().items(), key=lambda kv: -kv[1]):
        print(f"  {s:24s} {v:16,.2f}")
    print("\nspend by entity:")
    for e, v in sorted(led.by_entity().items(), key=lambda kv: -kv[1]):
        print(f"  {e:28s} {v:16,.2f}")
    print("\nunit economics:")
    for k, v in led.unit_economics().items():
        print(f"  {k:26s} {v:16,.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "by_source": led.by_source(),
                "by_entity": led.by_entity(),
                "unit_economics": led.unit_economics(),
                "meta": led.meta,
            }, f, indent=2)
    return 0


def cmd_diff(args) -> int:
    diff = _load(args.a).diff(_load(args.b))
    print(diff.report())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(diff.to_dict(), f, indent=2)
    if args.fail_above is not None and diff.max_abs_delta > args.fail_above:
        print(f"FAIL: max |spend delta| {diff.max_abs_delta:,.2f} > "
              f"{args.fail_above:,.2f}", file=sys.stderr)
        return 1
    return 0


def cmd_top(args) -> int:
    led = _load(args.a)
    if args.b is None:
        tot = led.cost.sum(axis=0)
        cells = [
            (led.entities[ei], led.sources[mi], float(tot[ei, mi]))
            for ei in range(len(led.entities))
            for mi in range(len(led.sources))
            if tot[ei, mi] != 0.0
        ]
        cells.sort(key=lambda c: -abs(c[2]))
        print(f"top {args.n} spend cells:")
        for e, s, v in cells[:args.n]:
            print(f"  {e:28s} {s:24s} {v:16,.2f}")
        return 0
    diff = led.diff(_load(args.b))
    print(f"top {args.n} spend movers (A - B):")
    for e, s, d in diff.top_movers(args.n):
        print(f"  {e:28s} {s:24s} {d:+16,.2f}")
    if args.fail_above is not None and diff.max_abs_delta > args.fail_above:
        print(f"FAIL: max |spend delta| {diff.max_abs_delta:,.2f} > "
              f"{args.fail_above:,.2f}", file=sys.stderr)
        return 1
    return 0


def cmd_calib(args) -> int:
    cube = CalibrationCube.from_jsonl(args.a)
    if args.b is None:
        print(cube.report())
        if args.json:
            with open(args.json, "w") as f:
                json.dump(cube.summary(), f, indent=2)
        drift = cube.max_coverage_drift
        if args.fail_above is not None and drift > args.fail_above:
            print(
                f"FAIL: max |coverage drift| {drift:.4f} > "
                f"{args.fail_above:.4f}", file=sys.stderr,
            )
            return 1
        return 0
    diff = cube.diff(CalibrationCube.from_jsonl(args.b))
    print(diff.report())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(diff.to_dict(), f, indent=2)
    if (
        args.fail_above is not None
        and diff.max_abs_coverage_delta > args.fail_above
    ):
        print(
            f"FAIL: max |coverage delta| "
            f"{diff.max_abs_coverage_delta:.4f} > {args.fail_above:.4f}",
            file=sys.stderr,
        )
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="summarize one ledger")
    p.add_argument("ledger")
    p.add_argument("--json", help="also write the summary as JSON")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("diff", help="compare two ledgers (A - B)")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", help="also write the diff as JSON")
    p.add_argument("--fail-above", type=float, default=None,
                   help="exit 1 if any |cell delta| exceeds this")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("top", help="top spend cells (one ledger) or "
                                   "movers (two)")
    p.add_argument("a")
    p.add_argument("b", nargs="?", default=None)
    p.add_argument("-n", type=int, default=10)
    p.add_argument("--fail-above", type=float, default=None,
                   help="with two ledgers: exit 1 on a larger mover")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser(
        "calib",
        help="calibration coverage report (one cube) or delta (two)",
    )
    p.add_argument("a")
    p.add_argument("b", nargs="?", default=None)
    p.add_argument("--json", help="also write the summary/diff as JSON")
    p.add_argument(
        "--fail-above", type=float, default=None,
        help="exit 1 when coverage drift (one cube) or the coverage "
             "delta (two cubes) exceeds this",
    )
    p.set_defaults(fn=cmd_calib)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
