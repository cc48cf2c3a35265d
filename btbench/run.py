"""The benchmark of gr_bluetooth_tpu_torch, one run of one cell:

    python3 btbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout holding BENCHMARK.json.  Prints the result
as the last line of standard output (harness/main.py says what it holds).
"""
import os
import sys
import time


def _process_start() -> float:
    """perf_counter() at this process's start (from /proc; now where
    /proc cannot say)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
# one process, few threads: the host's math libraries run single-threaded
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_v] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from btbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
