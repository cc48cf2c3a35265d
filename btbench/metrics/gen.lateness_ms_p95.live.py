"""gen.lateness_ms_p95.live: how late the open-loop generator handed
each due chunk over, p95, ms (harness clock)."""
from btbench.harness.readings import p95


def read(run):
    w = run.window
    if w.loop != "open":
        return None
    v = p95([h - d for h, d in zip(w.handed, w.due)])
    return None if v is None else v * 1e3
