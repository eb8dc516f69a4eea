"""The control's readings on the chip: for each seed, one run of the cell
with the reference stored in bfloat16 in the program's place (a short
window of the cell's own load), each compared number printed beside its
limit. Every number the control reads above its limit shows that the
comparison catches a program that computes in the next lower precision.

    python3 cfdbench/control.py --workload <cell> --seeds 1,2,3
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.run_cell(args.workload, seed, 0.0, False, args.device,
                         control=True, min_steps=3, rehearse=args.rehearse)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
