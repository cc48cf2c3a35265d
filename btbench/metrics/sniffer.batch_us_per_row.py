"""sniffer.batch_us_per_row: the port's sniffer.batch_decode stage, all
its time over the rows handed to core/batch_decode (counter
sniffer.batch_rows), us."""
from btbench.harness.program import counter


def read(run):
    calls, total = run.stages.get("sniffer.batch_decode", (0, 0.0))
    rows = counter("sniffer.batch_rows")
    return total / rows * 1e6 if calls and rows else None
