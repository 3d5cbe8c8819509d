"""Entry point of the port's benchmark:

    python3 vbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout (``python -m vbench.run`` works too). The
set-up time counts from the start of this process.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def _process_age_s() -> float:
    """Seconds since this process started, by the kernel's start time (the
    interpreter's own start-up before the first line; 0 if unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T0 -= _process_age_s() - (time.perf_counter() - _T0)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=_T0))
