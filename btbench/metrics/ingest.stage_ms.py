"""ingest.stage_ms: the port's ingest.stage (the wire chunk into the
pinned ring slot, inside h2d) per block, ms."""
from btbench.harness.readings import stage_ms


def read(run):
    return stage_ms(run, "ingest.stage")
