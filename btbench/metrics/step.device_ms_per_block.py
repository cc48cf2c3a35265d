"""step.device_ms_per_block: device time of every kernel and memset in
the traced window (copies left out), per block, ms."""
from btbench.harness.readings import blocks, device_s


def read(run):
    s = device_s(run)
    return None if not s or not blocks(run) else s / blocks(run) * 1e3
