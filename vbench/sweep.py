"""The open loop's knee, found once by a sweep on the card:

    python3 vbench/sweep.py --workload esrgan_x4plus.open_mixed --seed 7 --seconds 15 --rates 20 25 30 35 40

For each rate, in one process, a run of the cell with its mix at that rate
(``harness.run`` with the traffic's ``rate_per_s`` replaced): p50 and p95
latency from the due time, the answers completed a second, and the backlog,
the requests due in the window that were not answered by its close. The
highest rate whose backlog stays near empty is the knee; the cell runs at
0.8 of it. One JSON line a rate.
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
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=15.0)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args(argv)

    import torch

    from vbench import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    for rate in args.rates:
        r = harness.run(args.workload, args.seed, args.seconds, False,
                        traffic_overrides={"rate_per_s": rate, "late_wait_s": 30.0})
        print(json.dumps({"rate_per_s": rate, "p50_ms": r["metrics"].get("p50_ms", {}).get("value"),
                          "p95_ms": r["metrics"].get("p95_ms", {}).get("value"),
                          "answered_per_s": r["loadgen"]["completed_in_window"] / args.seconds,
                          "backlog_at_close": r["loadgen"]["backlog_at_close"], "attempted": r["attempted"],
                          "failed": r["failed"], "sender_late_p95_ms": r["loadgen"]["sender_late_p95_ms"],
                          "correct": r["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
