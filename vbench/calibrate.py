"""The readings that a cell's limit is set from, in one process:

    python3 vbench/calibrate.py --workload <name> --seconds 4 --seeds 11 12 13 ...

For each seed, a short run of the cell at its own sizes and load (the same
``harness.run`` as the benchmark's), its compared number, and the control's:
the plain reference in float8 in the program's place, read on the same kept
answers' inputs. One JSON line a seed on standard output, then the largest
program reading (the lower reading) and the smallest control reading (the
upper one). Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--no-control", action="store_true", help="read the program only")
    args = parser.parse_args(argv)

    import torch

    from vbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    program, control = [], []
    for seed in args.seeds:
        r = harness.run(args.workload, seed, args.seconds, False, control=not args.no_control)
        row = {"seed": seed, "rms_u8": r["checks"]["rms_u8"]["value"], "off3_pct": r["readings"]["off3_pct"],
               "compared": r["checks"]["compared"]["value"], "failed": r["failed"],
               "control": r.get("control_checks"), "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
        print(json.dumps(row), flush=True)
        program.append(row["rms_u8"])
        if row["control"]:
            control.append(row["control"]["rms_u8"])
    print(json.dumps({"workload": args.workload, "lower_reading": max(program),
                      "upper_reading": min(control) if control else None, "seeds": len(program),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
