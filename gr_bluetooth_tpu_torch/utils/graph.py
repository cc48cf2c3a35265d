"""Compiled steps: a function of tensors with static shapes, captured
once as a CUDA graph and replayed, as the JAX package jits its steps.

The port's counterpart of jax.jit's compile cache.  The JAX package
compiles each step once per static configuration (`_device_step`,
`_pipelined_step`, the ingest's `_pack`, the sharded step) and then
dispatches one program per block; here the step is captured once into a
torch.cuda.CUDAGraph and each block is one replay.

CompiledStep(fn, example_inputs) owns the step's static buffers:
`inputs`, copies of the examples, and `outputs`, what fn returned.

  * On a CUDA device fn runs twice on a side stream first (one-time work
    happens there: detect_kernel._check_masks' one host read, lazy module
    loads, the kernel launchers' per-device attribute and occupancy
    caches, cuFFT plans and cuBLAS/cuDNN workspaces), then it is
    captured on the step's stream, the one that replays it.  A capture
    or replay error raises; nothing falls back to the eager form.  The
    capture runs in the default (global) mode: no other thread of the
    process makes CUDA calls while a step is captured.
  * On the CPU fn runs at every call, with the same bookkeeping: the
    arguments are copied into `inputs` and the results into `outputs`,
    so the CPU tests see the aliasing that replay imposes.

Aliasing.  A call writes the same `outputs` every time, and the steps of
one StepCache share one graph memory pool, so outputs hold until the
next call of any step of that cache: a caller that keeps them longer
clones them.  A function may also write its inputs in place (the
ingest's carry); the warm-up runs then leave them written, and the
caller sets them after the step is built.

Launch counts.  A replay calls no kernel wrapper, so the wrappers'
launch counters (pfb_snr.launches, ...) cannot count it.  The capture
records how many launches of each kernel the graph holds, and every
replay adds those to the counters.  The warm-up runs and the capture
produce no result and count nothing.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["CompiledStep", "StepCache"]


def _counters():
    """(wrapper, attribute) of every kernel launch counter."""
    from ..ops import (demod_kernel, detect, detect_kernel, hit_table, pfb,
                       pfb_kernel)
    return ((pfb_kernel.pfb_snr, "launches"),
            (demod_kernel.demod_pack, "launches"),
            (detect_kernel.detect_words, "launches"),
            (detect_kernel.detect_words, "err_launches"),
            (pfb_kernel.pfb_channelize, "launches"),
            (pfb.deinterleave, "launches"),
            (detect.le_detect, "launches"),
            (detect.le_detect, "dist_launches"),
            (hit_table.hit_table, "launches"),
            (hit_table.hit_table, "le_launches"))


def _read_counts() -> list[int]:
    return [getattr(f, a) for f, a in _counters()]


def _set_counts(values) -> None:
    for (f, a), v in zip(_counters(), values):
        setattr(f, a, v)


def _add_counts(delta) -> None:
    for (f, a), d in zip(_counters(), delta):
        if d:
            setattr(f, a, getattr(f, a) + d)


def _graphed(device: torch.device, graph: bool | None) -> bool:
    """Whether a step on `device` is captured: by default on CUDA."""
    return device.type == "cuda" if graph is None else graph


def _as_tuple(outs) -> tuple:
    return tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)


class CompiledStep:
    """fn(*inputs) -> a tensor or a tuple of tensors (None allowed), all
    of static shape, compiled for the device of its example inputs.
    `pool` is the graph memory pool to capture into, `stream` the stream
    that captures and replays the graph (a new one if not given; never
    the default stream, on which CUDA cannot capture).  `graph=False`
    runs fn at every call on a CUDA device too (the eager form, with the
    same bookkeeping; chip_smoke.py compares the two)."""

    def __init__(self, fn, example_inputs, *, pool=None, stream=None,
                 graph: bool | None = None):
        self.fn = fn
        self.device = example_inputs[0].device
        self.inputs = tuple(t.detach().clone() for t in example_inputs)
        self.outputs = None
        self.graph = None
        self.stream = None
        self._delta = None          # launches per replay, as _counters()
        if _graphed(self.device, graph):
            self._capture(pool, stream)

    def _capture(self, pool, stream):
        dev = self.device
        self.stream = stream if stream is not None else \
            torch.cuda.Stream(device=dev)
        before = _read_counts()
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.fn(*self.inputs)
            self.stream.wait_stream(side)
            cur.wait_stream(side)
            warm = _read_counts()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=self.stream):
                outs = _as_tuple(self.fn(*self.inputs))
        self._delta = [b - a for a, b in zip(warm, _read_counts())]
        # nothing the warm-up or the capture launched made a result
        _set_counts(before)
        self.graph = g
        self.outputs = outs

    @property
    def launches_per_replay(self) -> dict[str, int]:
        """{"wrapper.counter": launches} of one replay (empty for a step
        that is not a graph: its wrappers count themselves)."""
        return {f"{f.__name__}.{a}": d
                for (f, a), d in zip(_counters(), self._delta or ()) if d}

    @contextlib.contextmanager
    def on_stream(self):
        """Make the step's stream the current one, ordered after the
        caller's current stream on entry and before it on exit; nothing
        for a step that is not a graph."""
        if self.stream is None:
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        if cur == self.stream:
            yield
            return
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            yield
        cur.wait_stream(self.stream)

    def replay(self) -> tuple:
        """Run the step on `inputs` as they stand; returns `outputs`."""
        if self.graph is None:
            outs = _as_tuple(self.fn(*self.inputs))
            if self.outputs is None:
                self.outputs = tuple(None if o is None else o.clone()
                                     for o in outs)
            else:
                for dst, o in zip(self.outputs, outs):
                    if dst is not None:
                        dst.copy_(o)
            return self.outputs
        with self.on_stream():
            self.graph.replay()
        _add_counts(self._delta)
        return self.outputs

    def __call__(self, *args) -> tuple:
        """Copy `args` (tensors on any device, of the inputs' shapes and
        dtypes) into `inputs` on the step's stream, and replay."""
        if len(args) != len(self.inputs):
            raise TypeError(f"the step takes {len(self.inputs)} inputs, "
                            f"got {len(args)}")
        for dst, src in zip(self.inputs, args):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"the step was compiled for "
                                 f"{tuple(dst.shape)} {dst.dtype}, got "
                                 f"{tuple(src.shape)} {src.dtype}")
        with self.on_stream():
            for dst, src in zip(self.inputs, args):
                if src is not dst:
                    dst.copy_(src, non_blocking=True)
            return self.replay()


class StepCache:
    """One owner's compiled steps on one device (a FrontEnd's, or one
    shard's): a cache keyed as jax.jit's is, by (function and static
    configuration, device, input shapes and dtypes), whose graphs share
    one memory pool and one stream.  They never run concurrently, so a
    second step (another wire format, the other chain) reuses the first
    one's intermediate memory instead of adding its own."""

    def __init__(self, device, stream=None):
        self.device = torch.device(device)
        self.stream = stream
        self._pool = None
        self._steps: dict = {}

    def build(self, fn, example_inputs, graph: bool | None = None):
        """A new CompiledStep of fn on this cache's pool and stream (not
        cached: for a caller that owns the step's static inputs)."""
        if not _graphed(self.device, graph):
            return CompiledStep(fn, example_inputs, graph=False)
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return CompiledStep(fn, example_inputs, pool=self._pool,
                            stream=self.stream, graph=True)

    def get(self, key, fn, specs) -> CompiledStep:
        """The step of `key` (the function and its static configuration)
        at inputs of `specs`, [(shape, dtype)], compiled at first use
        from zero inputs."""
        k = (key, tuple((tuple(s), d) for s, d in specs))
        step = self._steps.get(k)
        if step is None:
            zeros = [torch.zeros(s, dtype=d, device=self.device)
                     for s, d in specs]
            step = self._steps[k] = self.build(fn, zeros)
        return step
