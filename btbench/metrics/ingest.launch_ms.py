"""ingest.launch_ms: the ingest's device_step per block (the step's
replay, the enqueue of its D2H copy and the event's record), ms."""
from btbench.harness.readings import stage_ms


def read(run):
    return stage_ms(run, "device_step")
