"""CLI: lint serialized plans offline —
``python -m dryad_tpu_torch.analysis plan.json [--stream] [--cost]``.

Runs the structural subset of the plan verifier over a plan JSON
artifact (``plan/serialize.graph_to_json`` output, of either package:
the wire format is one).  Exit code 1 when error-severity findings exist,
so CI can gate committed plan artifacts.

``--cost`` appends the offline capacity / row table
(``analysis/cost.estimate_plan_json``: callables and sources are gone
from a serialized plan, so bytes are unknown, but every capacity is
structural; size it with ``--nparts``).  No device is touched.
"""

from __future__ import annotations

import argparse
import sys

from dryad_tpu_torch.analysis import check_plan_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dryad_tpu_torch.analysis",
        description="statically lint a serialized plan "
                    "(graph_to_json output)")
    ap.add_argument("plan", help="plan JSON path ('-' for stdin)")
    ap.add_argument("--stream", action="store_true",
                    help="the plan will execute over cluster streams: "
                         "apply the streamed-mode op rules")
    ap.add_argument("--cost", action="store_true",
                    help="append the offline per-stage capacity/row "
                         "cost table (analysis/cost.py)")
    ap.add_argument("--nparts", type=int, default=1,
                    help="partition count for --cost row bounds "
                         "(default 1)")
    args = ap.parse_args(argv)
    if args.plan == "-":
        plan_json = sys.stdin.read()
    else:
        with open(args.plan) as f:
            plan_json = f.read()
    report = check_plan_json(plan_json, stream=args.stream)
    print(report.render())
    if args.cost:
        from dryad_tpu_torch.analysis.cost import estimate_plan_json
        print()
        print(estimate_plan_json(plan_json, nparts=args.nparts).render())
    return 1 if report.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
