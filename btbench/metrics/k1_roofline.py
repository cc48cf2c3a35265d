"""k1_roofline: K1's least time at the card's published peaks
(harness/costs.py, from the cell's shapes) over the device time of the
kernels that implement it (kernels/k1/*.txt name patterns), per block,
in %.  Nothing when no such kernel ran."""
from btbench.harness.readings import blocks, device_s


def read(run):
    s = device_s(run, run.kernel_patterns("k1"))
    if not s or not blocks(run):
        return None
    return 100.0 * run.k1["bound_s"] * blocks(run) / s
