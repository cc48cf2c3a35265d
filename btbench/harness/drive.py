"""The measured window: wire chunks handed to the ingest on a closed or
an open loop, the mode pulling its results, and the harness's clock at
every boundary between them.

Per block j the window records when its chunk was due (open loop: the
air time of its last sample), when it was handed over, when its result
came out of the ingest and when the mode asked for the next result
after handling it (the block's completion).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

__all__ = ["Window", "drive", "drive_sharded"]


@dataclass
class Window:
    loop: str
    t0: float = 0.0               # window start (perf_counter seconds)
    t_end: float = 0.0            # the last block's completion
    due: list = field(default_factory=list)        # open loop only
    handed: list = field(default_factory=list)
    yielded: list = field(default_factory=list)
    done: list = field(default_factory=list)
    hits: list = field(default_factory=list)       # classic + LE, per block
    n_due: int = 0                # open loop: blocks due in the window

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0


def _nospan(name):
    return contextlib.nullcontext()


def drive(mode, ingest, chunks, carry, *, loop: str, seconds: float,
          period_s: float, start_clkn: int, on_result=None, on_done=None,
          span=_nospan) -> Window:
    """Run one window of `mode.run_blocks(ingest.run(...))` over the
    chunks in a cycle.  Closed loop: chunks are handed over as fast as
    the ingest takes them until `seconds` have passed since the first;
    open loop: chunk j is due at t0 + (j + 1) period_s, for every j due
    within `seconds`, whenever the system is ready for it.  The ingest
    then drains, and every block handed over completes."""
    w = Window(loop=loop)
    P = len(chunks)
    if loop == "open":
        w.n_due = int(seconds / period_s + 1e-9)

    def feed():
        j = 0
        if loop == "open":
            w.t0 = time.perf_counter()
            for j in range(w.n_due):
                due = w.t0 + (j + 1) * period_s
                w.due.append(due)
                wait = due - time.perf_counter()
                if wait > 0:
                    with span("gen.wait"):
                        time.sleep(wait)
                w.handed.append(time.perf_counter())
                yield chunks[j % P]
            return
        w.t0 = time.perf_counter()
        stop = w.t0 + seconds
        while True:
            now = time.perf_counter()
            if j and now >= stop:
                return
            w.handed.append(now)
            yield chunks[j % P]
            j += 1

    def results():
        it = ingest.run(feed(), start_clkn, initial_carry=carry)
        j = 0
        while True:
            with span("ingest"):
                res = next(it, None)
            if res is None:
                return
            w.yielded.append(time.perf_counter())
            w.hits.append(len(res.hits) + len(res.le_hits))
            with span("mode"):
                yield res
                w.done.append(time.perf_counter())
            if on_result is not None:
                on_result(j, res)
            if on_done is not None:
                on_done(j, res)
            j += 1

    with span("window"):
        mode.run_blocks(results())
    w.t_end = w.done[-1] if w.done else time.perf_counter()
    return w


def drive_sharded(run_blocks, sharded, superblocks, *, seconds: float,
                  start_clkn: int, on_result=None, on_done=None,
                  span=_nospan) -> Window:
    """One closed-loop window over a time-sharded front end: each
    superblock's float32 planes and the head that follows it, in a
    cycle, through the loop body of ShardedFrontEnd.stream (place, step
    with the head as the last shard's halo, gather, assemble), the
    results to `run_blocks` (the mode's), until `seconds` have passed."""
    w = Window(loop="closed")

    def results():
        slot_base = start_clkn
        w.t0 = time.perf_counter()
        stop = w.t0 + seconds
        i = j = 0
        while i == 0 or time.perf_counter() < stop:
            chunk, head = superblocks[i % len(superblocks)]
            t = time.perf_counter()
            with span("ingest"):
                out = sharded.gather(sharded.step(sharded.device_put(chunk),
                                                  head))
                blocks = sharded._assemble(out, slot_base)
            for res in blocks:
                w.handed.append(t)
                w.yielded.append(time.perf_counter())
                w.hits.append(len(res.hits) + len(res.le_hits))
                with span("mode"):
                    yield res
                    w.done.append(time.perf_counter())
                if on_result is not None:
                    on_result(j, res)
                if on_done is not None:
                    on_done(j, res)
                j += 1
            slot_base += sharded.superblock_slots
            i += 1

    with span("window"):
        run_blocks(results())
    w.t_end = w.done[-1] if w.done else time.perf_counter()
    return w
