"""Quantities the metric readers share, from a run's record: the
window's per-block times, the program's stage accumulators and the
trace's device times."""
from __future__ import annotations

import math

__all__ = ["p95", "block_latencies", "us_per_hit", "stage_ms",
           "device_s", "blocks"]


def p95(values) -> float | None:
    """The 95th percentile (linear between order statistics)."""
    v = sorted(values)
    if not v:
        return None
    x = 0.95 * (len(v) - 1)
    i = int(math.floor(x))
    if i + 1 >= len(v):
        return v[-1]
    return v[i] + (v[i + 1] - v[i]) * (x - i)


def blocks(run) -> int:
    return len(run.window.done)


def block_latencies(run) -> list:
    """Seconds from each due block's due time to its completion; a
    block that never completed reads as infinite."""
    w = run.window
    return [(w.done[j] - d) if j < len(w.done) else math.inf
            for j, d in enumerate(w.due)]


def us_per_hit(run) -> float | None:
    """The mode's handling time over the window (a result's hand-over
    to the next request), per classic and LE hit."""
    w = run.window
    n = sum(w.hits[: len(w.done)])
    if not n:
        return None
    return sum(d - y for d, y in zip(w.done, w.yielded)) / n * 1e6


def stage_ms(run, name: str) -> float | None:
    """The program's metrics.stage(name) accumulator, ms per call."""
    calls, total = run.stages.get(name, (0, 0.0))
    return total / calls * 1e3 if calls else None


def device_s(run, patterns=None) -> float | None:
    """Device seconds in the traced window of the ops whose names match
    one of `patterns` (compiled regular expressions), or of every
    kernel and memset when `patterns` is None (copies left out)."""
    if run.trace is None:
        return None
    tot = 0.0
    for name, s in run.trace["op_s"].items():
        if patterns is None:
            if not name.startswith("Memcpy"):
                tot += s
        elif any(p.search(name) for p in patterns):
            tot += s
    return tot
