"""sniffer.precompute_ms: self time of the port's sniffer.precompute
stage per block (the symbol matrix and the header test; the batch
decode inside it left out), ms."""
from btbench.harness.program import stage_self


def read(run):
    v = stage_self("sniffer.precompute")
    return None if v is None else v[1] / v[0] * 1e3
