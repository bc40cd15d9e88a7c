"""``python -m dryad_tpu_torch.chaos`` — run kill-and-recover scenarios
and exit nonzero if any durability invariant breaks (the port of the
JAX package's chaos CLI; ``--device`` picks the victim's and the
successor's device, the CUDA card by default)."""

from __future__ import annotations

import argparse
import json
import shutil
import sys

from dryad_tpu_torch.chaos.harness import run_scenario


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dryad_tpu_torch.chaos",
        description="SIGKILL a durable job-service daemon mid-fleet, "
                    "restart it, and check the durability invariants.")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-plan seed (same seed = same scenario)")
    ap.add_argument("--runs", type=int, default=1,
                    help="scenarios to run (seeds seed..seed+runs-1)")
    ap.add_argument("--dir", default=None,
                    help="work dir (default: a fresh temp dir per run)")
    ap.add_argument("--keep", action="store_true",
                    help="keep work dirs even on success")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the daemons' device (default cuda)")
    args = ap.parse_args(argv)

    failed = 0
    for i in range(args.runs):
        seed = args.seed + i
        report = run_scenario(seed=seed, workdir=args.dir,
                              timeout=args.timeout, device=args.device)
        print(json.dumps(report, indent=2, sort_keys=True,
                         default=str))
        if not report["ok"]:
            failed += 1
            print(f"chaos: seed {seed} FAILED (work dir kept: "
                  f"{report['workdir']})", file=sys.stderr)
        elif not args.keep and args.dir is None:
            shutil.rmtree(report["workdir"], ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
