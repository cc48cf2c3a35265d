"""ingest.early_release_pct: the share of the window's blocks that the
ingest handed out before its DEPTH rule would have (the port's counter
ingest.early_release over its counter blocks), %.  None for a program
without that counter."""
from btbench.harness.program import counter


def read(run):
    early, blocks = counter("ingest.early_release"), counter("blocks")
    return early / blocks * 100.0 if early and blocks else None
