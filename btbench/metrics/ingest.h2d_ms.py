"""ingest.h2d_ms: the port's metrics.stage("h2d") per block, ms."""
from btbench.harness.readings import stage_ms


def read(run):
    return stage_ms(run, "h2d")
