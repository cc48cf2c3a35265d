"""ingest.device_wait_ms: the host waiting on the card inside the
ingest, per block: ingest.slot_wait (in h2d, the ring slot's last block
leaving the device) plus ingest.result_wait (in assemble, the block's
event), ms."""


def read(run):
    n, slot = run.stages.get("ingest.slot_wait", (0, 0.0))
    m, result = run.stages.get("ingest.result_wait", (0, 0.0))
    return (slot + result) / n * 1e3 if n and m else None
