"""The control of a cell's comparison: the plain reference put in the
program's place and computed one step below what the configuration
states, compared by the same numbers as the program.  It has to come out
not correct, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the control's numbers and the limits.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import bench  # noqa: E402


def readings(cell: "bench.Cell", seed: int, device) -> dict:
    """The control's numbers on the tables of ``seed``."""
    tables = cell.gen.make(cell.config, cell.traffic["reads"], seed,
                           torch.device(device))
    return cell.reference.control(tables, cell.traffic.get("params", {}))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.Cell(args.workload)
    for seed in args.seeds:
        nums = readings(cell, seed, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": nums,
                          "limits": cell.reference.LIMITS,
                          "fails": any(nums[k] > cell.reference.LIMITS[k]
                                       for k in nums)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
