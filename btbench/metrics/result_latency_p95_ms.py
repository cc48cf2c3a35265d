"""result_latency_p95_ms: over every block due in an open-loop window,
its due time (the air time of its last sample) to the mode's request
for the next result after handling it; p95 (host clock)."""
from btbench.harness.readings import block_latencies, p95


def read(run):
    if run.window.loop != "open":
        return None
    v = p95(block_latencies(run))
    return None if v is None else v * 1e3
