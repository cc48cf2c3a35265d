"""sharded.ms_per_superblock: the window's length over the superblocks
whose results the mode handled, one block per card each, ms (harness
clock)."""


def read(run):
    w = run.window
    n = len(w.done) / run.spec.chips
    if run.spec.chips < 2 or not n or w.seconds <= 0:
        return None
    return w.seconds / n * 1e3
