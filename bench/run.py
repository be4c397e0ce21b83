"""Run one cell of the benchmark once:

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  Exits 2, printing no result, without them."""
from __future__ import annotations

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED = time.perf_counter() - _process_age_s()

if __name__ == "__main__":
    from bench import harness

    sys.exit(harness.main(started=STARTED))
