"""Command line of the static auditor.

    python -m repro_torch.analysis [--cases fast|all|NAME,...]
        [--backends NAME,...]
        [--analyses smem,traffic,retrace,preflight,dma,while,interleave]
        [--json PATH] [--device cpu|cuda]

Prints one line per violation and a summary; exits 0 only if every
analysis passed. ``--device cuda`` (the default) builds the kernels first,
so ``smem`` also reads their static shared memory from the build log.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.report import ANALYSES, audit_all


def _split(value):
    return None if value is None else [v for v in value.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--cases", default="fast", help="fast, all, or comma-separated names")
    ap.add_argument("--backends", default=None, help="comma-separated backends (all)")
    ap.add_argument("--analyses", default=None,
                    help=f"comma-separated subset of {','.join(ANALYSES)}")
    ap.add_argument("--json", default=None, help="write the report to this path")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    cases = args.cases if args.cases in ("fast", "all") else _split(args.cases)
    report = audit_all(backends=_split(args.backends), cases=cases,
                       analyses=_split(args.analyses), device=args.device)
    for v in report["violations"]:
        print(f"[{v['analysis']}] {v['backend']}/{v['algorithm']}/{v['case']}: {v['message']}")
    print(f"audited {len(report['records'])} (backend, algorithm, case) records on "
          f"{report['device']}: {len(report['violations'])} violations; skipped "
          f"{[s['backend'] for s in report['skipped']]}; ok={report['ok']}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1, default=str)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
