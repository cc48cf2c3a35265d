"""Counters, stage timings, and profiler hooks (SURVEY §5: the reference
has no metrics framework — only printf; here: torch profiler +
per-stage timing).

A Metrics object aggregates:
  * monotonically increasing counters (packets, hits, frames, drops)
  * per-stage wall-time accumulators with call counts (the `stage` context
    manager), giving mean/total per pipeline stage
  * derived throughput (samples or slots per second)

`profile()` wraps a region in torch.profiler and writes a Chrome trace
(Perfetto-readable) into log_dir; a no-op when log_dir is None.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["Metrics", "metrics", "profile"]


@dataclass
class _Stage:
    calls: int = 0
    total_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0


@dataclass
class Metrics:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    stages: dict = field(default_factory=lambda: defaultdict(_Stage))
    started: float = field(default_factory=time.time)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self.stages[name]
            s.calls += 1
            s.total_s += time.perf_counter() - t0

    def throughput(self, counter: str) -> float:
        dt = time.time() - self.started
        return self.counters[counter] / dt if dt > 0 else 0.0

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "stages": {k: {"calls": v.calls, "total_s": round(v.total_s, 6),
                           "mean_s": round(v.mean_s, 6)}
                       for k, v in self.stages.items()},
            "uptime_s": round(time.time() - self.started, 3),
        }

    def report(self) -> str:
        snap = self.snapshot()
        lines = [f"uptime: {snap['uptime_s']}s"]
        for k in sorted(snap["counters"]):
            lines.append(f"  {k}: {snap['counters'][k]}")
        for k, v in sorted(snap["stages"].items()):
            lines.append(f"  stage {k}: {v['calls']} calls, "
                         f"{v['total_s']:.3f}s total, {v['mean_s']*1e3:.2f}ms avg")
        return "\n".join(lines)

    def reset(self):
        self.counters.clear()
        self.stages.clear()
        self.started = time.time()


metrics = Metrics()      # process-global default, like utils.log.bus


@contextlib.contextmanager
def profile(log_dir: str | None):
    """torch.profiler region (host + CUDA activity when a card is
    present); writes <log_dir>/trace.json.  No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
