"""sniffer.classic_us_per_hit: self time of the port's sniffer.classic
stage (the per-hit loop; a batch decode inside it left out) over the
classic hits (counter classic_hits), us."""
from btbench.harness.program import counter, stage_self


def read(run):
    v, hits = stage_self("sniffer.classic"), counter("classic_hits")
    return None if v is None or not hits else v[1] / hits * 1e6
