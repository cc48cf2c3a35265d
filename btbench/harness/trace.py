"""The traced run's reading of the profiler: device time by operation,
the device's busy share of the window, and its idle gaps named by the
harness span the host was in.

Events come from torch.profiler's kineto results (CPU activity for the
harness's record_function spans, CUDA activity for kernels, copies and
memsets), all on one clock.
"""
from __future__ import annotations

__all__ = ["Tracer", "reduce_events", "merge"]

SPANS = ("window", "ingest", "mode", "gen.wait")


class Tracer:
    """torch.profiler over the window, with the harness's spans."""

    def __init__(self, cuda: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._torch = torch
        self.prof = profile(activities=acts)

    def span(self, name):
        return self._torch.profiler.record_function(name)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def events(self):
        """(name, device index or None, start_ns, end_ns) of every
        event."""
        from torch.autograd import DeviceType
        out = []
        for e in self.prof.profiler.kineto_results.events():
            dev = e.device_type() == DeviceType.CUDA
            if dev and (e.is_user_annotation() or e.name() in SPANS):
                # a record_function range's copy on the device's
                # timeline: a span, not device work
                continue
            s = e.start_ns()
            out.append((e.name(), e.device_index() if dev else None, s,
                         s + e.duration_ns()))
        return out


def merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events, n_devices: int = 1, n_gaps: int = 10,
                  n_ops: int = 10) -> dict:
    """Events -> the window's device reading: window_s, busy_s (the union
    of each card's activity inside the window, averaged over the
    n_devices cards), op_s {device op name: seconds, summed over cards},
    device_ops and idle_gaps (the longest stretches with no card busy,
    named by the innermost harness span at the gap's middle)."""
    wins = [(s, e) for n, d, s, e in events if d is None and n == "window"]
    if not wins:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = wins[0]
    dev = [(n, d, max(s, w0), min(e, w1)) for n, d, s, e in events
           if d is not None and e > w0 and s < w1]
    op_s: dict = {}
    per: dict = {}
    for n, d, s, e in dev:
        op_s[n] = op_s.get(n, 0.0) + (e - s) * 1e-9
        per.setdefault(d, []).append((s, e))
    busy_s = sum(sum(e - s for s, e in merge(iv)) for iv in per.values()) \
        * 1e-9 / max(n_devices, 1)
    busy = merge([(s, e) for _, _, s, e in dev])
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    spans = sorted((s, e, n) for n, d, s, e in events
                   if d is None and n in SPANS and n != "window")
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:n_gaps]:
        mid = (s + e) // 2
        inner = "window"
        width = None
        for a, b, n in spans:
            if a > mid:
                break
            if b >= mid and (width is None or b - a < width):
                inner, width = n, b - a
        named.append([inner, (e - s) * 1e-9])
    ops = sorted(op_s.items(), key=lambda kv: -kv[1])[:n_ops]
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy_s, op_s=op_s,
                device_ops=[[n, v] for n, v in ops], idle_gaps=named)
