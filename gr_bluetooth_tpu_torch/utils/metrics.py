"""Counters, stage spans, and profiler hooks (SURVEY §5: the reference
has no metrics framework — only printf; here: torch profiler +
per-stage timing).

A Metrics object aggregates:
  * monotonically increasing counters (packets, hits, frames, drops)
  * per-stage wall-time accumulators (the `stage` context manager): call
    counts, total time, and self time (the total less the time the
    stages opened inside it covered, found by a stack of open stages per
    thread)

A stage is the port's span.  While a torch profiler records (btrx
--profile's `profile()`, or a benchmark's own), each stage also opens a
profiler range of its name, so the program's spans land in the
profiler's trace on the clock its device activity uses, and is logged
as (name, start_s, end_s) in `Metrics.spans`.  With no profiler
recording, the only cost beyond the accumulators is one flag check.

`SPANS` names every stage the port opens.  `profile()` wraps a region in
torch.profiler and writes a Chrome trace (Perfetto-readable) into
log_dir; a no-op when log_dir is None.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

__all__ = ["Metrics", "SPANS", "metrics", "profile"]

# every stage name the port opens; a dotted name is a child of the stage
# it runs inside (ingest.* of h2d and assemble, sniffer.* of
# sniffer.block)
SPANS = (
    "wire_encode",                  # FrontEnd.stream: host planes -> wire
    "h2d",                          # ingest: a chunk onto the device
    "ingest.slot_wait",             #   the ring slot's last block leaves
    "ingest.stage",                 #   the chunk into the pinned slot
    "device_step",                  # the step's launch (replay, D2H, event)
    "assemble",                     # a block's outputs into hits
    "ingest.result_wait",           #   the block's event
    "sniffer.block",                # Sniffer.run_blocks, one block
    "sniffer.precompute",           #   symbol matrix, header test
    "sniffer.batch_decode",         #   core/batch_decode rows
    "sniffer.classic",              #   the per-hit loop
    "sniffer.le",                   #   the LE hits
)

_profiling = torch._C._autograd._profiler_enabled
# a profiler range of the cpu_op kind: about a quarter of
# record_function's cost under the profiler, and, not being a user
# annotation, no copy of it on the device's timeline
_range = torch._C._profiler._RecordFunctionFast


class _Open(threading.local):
    """The stages open on each thread, innermost last."""

    def __init__(self):
        self.stack = []


@dataclass
class _Stage:
    calls: int = 0
    total_s: float = 0.0
    self_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0


class _Span:
    """One open stage: its start and the time its children took."""
    __slots__ = ("m", "name", "rng", "t0", "child_s")

    def __init__(self, m: Metrics, name: str):
        self.m = m
        self.name = name

    def __enter__(self):
        self.rng = None
        if _profiling():
            self.rng = _range(self.name)
            self.rng.__enter__()
        self.m._open.stack.append(self)
        self.child_s = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        dt = t1 - self.t0
        stack = self.m._open.stack
        stack.pop()
        if stack:
            stack[-1].child_s += dt
        s = self.m.stages[self.name]
        s.calls += 1
        s.total_s += dt
        s.self_s += dt - self.child_s
        if self.rng is not None:
            self.m.spans.append((self.name, self.t0, t1))
            self.rng.__exit__(*exc)
        return False


@dataclass
class Metrics:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    stages: dict = field(default_factory=lambda: defaultdict(_Stage))
    spans: list = field(default_factory=list)
    started: float = field(default_factory=time.time)
    _open: _Open = field(default_factory=_Open, repr=False, compare=False)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def stage(self, name: str) -> _Span:
        """Context manager timing one stage (a name of SPANS)."""
        return _Span(self, name)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "stages": {k: {"calls": v.calls, "total_s": round(v.total_s, 6),
                           "mean_s": round(v.mean_s, 6),
                           "self_s": round(v.self_s, 6)}
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
        self.spans.clear()
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

    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
