"""ingest.hold_ms_p95.live: how long a block stays inside the ingest,
from the start of its h2d to the start of its assemble, p95 over the
window's blocks, open-loop cells, ms.  The ingest is FIFO, so the j-th
h2d and the j-th assemble of the program's span log are one block's."""
from btbench.harness.program import starts
from btbench.harness.readings import p95


def read(run):
    if run.window.loop != "open":
        return None
    v = p95([a - h for h, a in zip(starts("h2d"), starts("assemble"))])
    return None if v is None else v * 1e3
