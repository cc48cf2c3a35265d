"""Input sources: .cfile / interleaved-short files, stdin streaming, and
a live drop-oldest source — the reference's source selection minus the
SDR hardware sources (apps/btrx:88-138).

The port of gr_bluetooth_tpu/io/sources.py.  Host-side numpy and the
native ring (io/native.py); the wire tables WIRES and WIRE_ZERO_BYTE are
io/ingest.py's, the one definition of each.

load_file yields float32 (2, N) IQ planes; the streaming sources yield
raw wire chunks for io/ingest.PipelinedIngest.
"""
from __future__ import annotations

import os
import sys
import threading

import numpy as np

from . import native
from .ingest import WIRE_ZERO_BYTE, WIRES

__all__ = ["LiveSource", "WIRE_DTYPE", "WIRE_ITEMSIZE", "WIRE_ZERO_BYTE",
           "load_file", "stream_stdin_raw"]


def _to_planes(arr: np.ndarray) -> np.ndarray:
    return np.stack([arr.real, arr.imag]).astype(np.float32)


def load_file(path: str, input_shorts: bool = False,
              nsamples: int | None = None,
              input_bytes: bool = False) -> np.ndarray:
    """Read a capture file: complex64 .cfile (blocks.file_source layout),
    interleaved int16 IQ (-s, apps/btrx:134-138), or interleaved int8."""
    if input_shorts or input_bytes:
        dt = np.int8 if input_bytes else np.int16
        raw = np.fromfile(path, dtype=dt,
                          count=-1 if nsamples is None else 2 * nsamples)
        raw = raw[: (len(raw) // 2) * 2].astype(np.float32).reshape(-1, 2)
        return np.ascontiguousarray(raw.T)
    raw = np.fromfile(path, dtype=np.complex64,
                      count=-1 if nsamples is None else nsamples)
    return _to_planes(raw)


WIRE_ITEMSIZE = {"f32": 8, "i16": 4, "i8": 2,      # bytes per IQ sample
                 "u8": 2,                          # rtl_sdr offset bytes
                 "i4": 1}                          # packed IQ nibbles
WIRE_DTYPE = {wire: dtype for wire, (dtype, _) in WIRES.items()}

def stream_stdin_raw(chunk_samples: int, wire: str = "f32",
                     nsamples: int | None = None, ring_mb: int = 64):
    """Yield RAW interleaved (chunk_samples, 2) wire-dtype arrays from
    stdin — no host float conversion (the pipelined ingest does it on
    device).  wire: 'f32' (complex64 stream = interleaved float32 pairs),
    'i16' (`-s`, apps/btrx:134-138), or 'i8'.

    Uses the native SPSC ring + reader thread when available
    (backpressure mode — stdin is a pipe), plain blocking reads
    otherwise."""
    itemsize = WIRE_ITEMSIZE[wire]
    dtype = WIRE_DTYPE[wire]
    need_bytes = chunk_samples * itemsize
    lib = native.load()
    fd = sys.stdin.fileno()
    produced = 0

    def convert(buf: bytes) -> np.ndarray:
        a = np.frombuffer(buf, dtype=dtype)
        return a if wire == "i4" else a.reshape(-1, 2)

    if lib is not None:
        import ctypes
        ring = lib.bt_ring_create(os.dup(fd), ring_mb << 20, 0)
        buf = ctypes.create_string_buffer(need_bytes)
        pending = b""
        try:
            while nsamples is None or produced < nsamples:
                # blocking pop: a starved consumer sleeps on the ring's
                # condvar instead of spinning a host core (the host
                # thread is also the decode thread)
                n = lib.bt_ring_pop_wait(ring, buf,
                                         need_bytes - len(pending), 100)
                if n < 0:
                    break
                if n == 0:
                    continue
                pending += buf.raw[:n]
                if len(pending) >= need_bytes:
                    yield convert(pending[:need_bytes])
                    produced += chunk_samples
                    pending = pending[need_bytes:]
            if pending and (nsamples is None or produced < nsamples):
                zb = bytes([WIRE_ZERO_BYTE[wire]])
                pad = pending + zb * (need_bytes - len(pending))
                yield convert(pad)
        finally:
            lib.bt_ring_destroy(ring)
    else:
        f = sys.stdin.buffer
        while nsamples is None or produced < nsamples:
            buf = f.read(need_bytes)
            if not buf:
                break
            if len(buf) < need_bytes:
                zb = bytes([WIRE_ZERO_BYTE[wire]])
                buf = buf + zb * (need_bytes - len(buf))
            yield convert(buf)
            produced += chunk_samples


class LiveSource:
    """Bounded-memory live fd source: drop-oldest ring + overrun accounting.

    The stand-in for a live SDR stream (apps/btrx:88-120 osmosdr
    source): when the consumer falls behind, the native ring drops the
    OLDEST samples (a live radio cannot backpressure the air) and counts
    overruns, which are surfaced into the metrics registry.  Requires the
    native runtime; raises RuntimeError if the toolchain is unavailable.

    iter_raw may run on another thread than close() (the pipelined
    ingest pulls its source on a thread of its own): a lock keeps the
    ring from being destroyed under a pop or a count, an iteration that
    finds the source closed ends, and the counts read after close() are
    those the ring held when it closed.
    """

    def __init__(self, fd: int, chunk_samples: int,
                 input_shorts: bool = False, ring_mb: int = 64,
                 metrics=None, wire: str | None = None):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (live source "
                               "needs the drop-oldest ring)")
        self._lib = lib
        self.wire = wire or ("i16" if input_shorts else "f32")
        self.input_shorts = self.wire == "i16"
        self.itemsize = WIRE_ITEMSIZE[self.wire]
        self.chunk_samples = chunk_samples
        self.need_bytes = chunk_samples * self.itemsize
        if metrics is None:
            from ..utils.metrics import metrics as default_metrics
            metrics = default_metrics
        self._metrics = metrics
        self._reported_dropped = 0
        self._lock = threading.RLock()
        self._closing = False
        self._closed_counts = (0, 0)    # (overruns, dropped) at close
        self._ring = lib.bt_ring_create(os.dup(fd), ring_mb << 20, 1)
        if not self._ring:
            raise RuntimeError("ring allocation failed")

    @property
    def overruns(self) -> int:
        with self._lock:
            if self._ring is None:
                return self._closed_counts[0]
            return int(self._lib.bt_ring_overruns(self._ring))

    @property
    def dropped_bytes(self) -> int:
        with self._lock:
            if self._ring is None:
                return self._closed_counts[1]
            return int(self._lib.bt_ring_dropped(self._ring))

    def _account(self):
        d = self.dropped_bytes
        new = d - self._reported_dropped
        if new:
            self._metrics.count("samples_dropped", new // self.itemsize)
            self._reported_dropped = d

    def take_dropped_samples(self) -> int:
        """Samples dropped since the last call — the clock-slip feed for
        the streaming loop (ingest.live_chunks), which must advance
        clkn by the dropped air time (piconet discovery consumes slot
        differences, lib/piconet_impl.cc:445-453)."""
        d = self.dropped_bytes
        new = d - getattr(self, "_slip_reported", 0)
        self._slip_reported = d
        return new // self.itemsize

    def iter_raw(self):
        """Yield RAW interleaved (chunk_samples, 2) wire-dtype arrays —
        the pipelined-ingest feed (device does the float conversion)."""
        import ctypes
        dtype = WIRE_DTYPE[self.wire]
        buf = ctypes.create_string_buffer(self.need_bytes)
        pending = b""
        while True:
            with self._lock:
                if self._closing or self._ring is None:
                    return
                # blocking pop (100 ms cap): idle btrx costs ~0 CPU
                # instead of a spinning core stolen from the decode thread
                n = self._lib.bt_ring_pop_wait(
                    self._ring, buf, self.need_bytes - len(pending), 100)
                if n < 0:
                    self._account()
                    return
                if n == 0:
                    continue
                pending += buf.raw[:n]
                self._account()
            if len(pending) >= self.need_bytes:
                chunk, pending = (pending[:self.need_bytes],
                                  pending[self.need_bytes:])
                a = np.frombuffer(chunk, dtype=dtype)
                yield a if self.wire == "i4" else a.reshape(-1, 2)

    def __iter__(self):
        for raw in self.iter_raw():
            if self.wire == "f32":
                yield np.ascontiguousarray(raw.T)
            else:
                scale = 1.0 / 32768.0 if self.wire == "i16" else 1.0 / 128.0
                yield np.ascontiguousarray(
                    raw.T.astype(np.float32)) * scale

    def close(self):
        # seen by an iteration between two pops, which then ends and
        # leaves the lock to this call
        self._closing = True
        with self._lock:
            if self._ring:
                self._account()
                self._closed_counts = (self.overruns, self.dropped_bytes)
                self._lib.bt_ring_destroy(self._ring)
                self._ring = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
