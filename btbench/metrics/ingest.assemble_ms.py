"""ingest.assemble_ms: the port's metrics.stage("assemble") per block,
ms."""
from btbench.harness.readings import stage_ms


def read(run):
    return stage_ms(run, "assemble")
