"""Production ingest: pipelined host->device streaming.

The port of gr_bluetooth_tpu/io/ingest.py.  The contract has three parts:

  * **wire format on the wire**: the host ships each block's NEW samples
    exactly as they arrive from the SDR — interleaved (N, 2) int16 (or
    int8 / float32 / rtl-sdr u8, or int4 packed one sample per byte) —
    and the device converts, scales and deinterleaves them (wire_decode).
  * **device-side overlap-save carry**: the device keeps the previous
    block's tail (lookahead + filter history), so no sample crosses the
    link twice.
  * **pipelining**: on a CUDA device each chunk is staged in pinned host
    memory and copied with non_blocking=True into the compiled step's
    static chunk buffer; the step is one CUDA graph replay; its outputs,
    packed into one int32 buffer, are copied device->host into pinned
    memory with one non_blocking copy, and an event is recorded after
    it.  Nothing on the step reads a value back to the host.  At most
    DEPTH blocks stay in flight past the one being assembled.  A source
    that keeps the loop waiting (a live radio) is pulled on a thread of
    its own, one item ahead, and a block's result is handed out as soon
    as its event has completed; when no chunk is ready the host waits on
    the oldest block's event rather than on the source, so the wait for
    the air never holds a finished result back.  A source that stays
    ahead (a replay) is pulled by the loop, which then keeps DEPTH
    blocks in flight.

Clock correctness under overruns: a live radio cannot backpressure the
air, so when the drop-oldest ring (io/sources.LiveSource) sheds samples
the clock must advance with air time, not with bytes consumed — CLK1-6
interval discovery and CLK1-27 winnowing consume slot differences
(lib/piconet_impl.cc:445-453).  `live_chunks` converts dropped samples to
whole slots (nearest, with the sub-slot residual carried forward) and
emits _Slip markers; `PipelinedIngest.run` advances slot_base and resets
the stale device carry at each one, and sends nothing to the device for
it.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.metrics import metrics

__all__ = ["PipelinedIngest", "WIRES", "WIRE_ZERO_BYTE", "live_chunks",
           "wire_chunks", "wire_decode", "wire_decode_np", "wire_encode"]

# wire formats: dtype on the link, scale applied on device.  "i4" packs
# one complex sample per BYTE (I nibble low, Q nibble high, two's-
# complement 4-bit); "u8" is rtl_sdr's unsigned offset bytes
# (x = (b - 127.5) / 127.5)
WIRES = {
    "f32": (np.float32, 1.0),
    "i16": (np.int16, 1.0 / 32768.0),
    "i8": (np.int8, 1.0 / 128.0),
    "i4": (np.uint8, 1.0 / 8.0),
    "u8": (np.uint8, 1.0 / 127.5),
}
# the byte that decodes to (approximately) zero signal — tail padding
# must use it: a 0x00 pad is full-scale -1-1j in the u8 offset format
WIRE_ZERO_BYTE = {"f32": 0, "i16": 0, "i8": 0, "u8": 127, "i4": 0}

DEPTH = 4   # blocks in flight past the one being assembled, at most
_JOIN_S = 1.0   # how long a run that ends waits for its source thread
# a pull that keeps the host off its CPU this long waited for its source
# (a block of air is 5 ms or more), or the host was busy elsewhere: two
# such pulls in a row are the source's
_WAITED_S = 1e-3


def wire_encode(x, wire: str) -> np.ndarray:
    """(2, N) float32 planes -> the on-the-wire array, quantized exactly
    as the device-side decode will see it."""
    inter = np.ascontiguousarray(np.asarray(x, np.float32).T)  # (N, 2)
    if wire == "f32":
        return inter
    if wire == "i4":
        q = np.clip(np.round(inter * 8.0), -8, 7).astype(np.int8)
        return ((q[:, 0] & 0xF) | ((q[:, 1] & 0xF) << 4)).astype(np.uint8)
    if wire == "u8":
        return np.clip(np.round(inter * 127.5 + 127.5), 0,
                       255).astype(np.uint8)
    dtype, scale = WIRES[wire]
    lim = {"i16": 32767.0, "i8": 127.0}[wire]
    return np.clip(inter / scale, -lim - 1, lim).astype(dtype)


def wire_decode_np(inter: np.ndarray, wire: str) -> np.ndarray:
    """Wire array -> (2, N) float32 planes; the numpy mirror of
    wire_decode (used for carries and file replays)."""
    _, scale = WIRES[wire]
    if wire == "i4":
        b = np.asarray(inter).astype(np.int32)
        i4 = (b & 0xF).astype(np.float32)
        q4 = ((b >> 4) & 0xF).astype(np.float32)
        i4 -= 16.0 * (i4 >= 8)
        q4 -= 16.0 * (q4 >= 8)
        return np.ascontiguousarray(np.stack([i4, q4]) * scale)
    x = np.asarray(inter).astype(np.float32).T
    if wire == "u8":
        x = x - 127.5
    return np.ascontiguousarray(x * scale if scale != 1.0 else x)


def wire_decode(new: torch.Tensor, wire: str) -> torch.Tensor:
    """Device-side wire -> (2, N) float32 planes, bit-identical to
    wire_decode_np."""
    _, scale = WIRES[wire]
    if wire == "i4":
        b = new.to(torch.int32)                        # (N,) packed bytes
        i4 = (b & 0xF).to(torch.float32)
        q4 = ((b >> 4) & 0xF).to(torch.float32)
        i4 = i4 - 16.0 * (i4 >= 8)
        q4 = q4 - 16.0 * (q4 >= 8)
        return torch.stack([i4, q4]) * scale
    x = new.to(torch.float32).T
    if wire == "u8":
        x = x - 127.5
    return (x * scale if scale != 1.0 else x).contiguous()


@dataclass
class _Slip:
    """A clock discontinuity: the source dropped `slots` slots of air."""
    slots: int
    samples: int


class _Slot:
    """One block's host buffers in the ring: its wire chunk on the way in
    and its packed outputs on the way out (pinned on a card, the packed
    buffer sized at its first use), and the event recorded after the
    block's device-to-host copy."""

    def __init__(self, chunk_shape, dtype, pin: bool):
        self.pin = pin
        self.chunk = torch.empty(chunk_shape, dtype=dtype, pin_memory=pin)
        self.out = None
        self.event = torch.cuda.Event() if pin else None

    def wait(self):
        """Block until this slot's last block has left the device."""
        if self.event is not None:
            self.event.synchronize()

    def done(self) -> bool:
        """Whether this slot's last block has left the device, without
        waiting."""
        return self.event is None or self.event.query()


_END = object()     # the end of the source, in the feed's stream order


@dataclass
class _Raised:
    """An exception the source raised, carried to the consumer in
    stream order."""
    exc: BaseException


class _Feed:
    """The chunk stream as the ingest loop takes it: get(block=False)
    says whether a chunk is ready without waiting for the source.

    While the source keeps the loop waiting (a live radio, a pipe, a
    caller that sends a chunk once it has the last result), a daemon
    thread pulls it into a queue of one item, the end of the stream
    (_END) and an exception of the source (_Raised) in stream order with
    the chunks and _Slip markers.  The thread only pulls: the loop's
    thread alone touches the CUDA stream, the ring, the carry and the
    metrics' stages.  The queue holds one item so that the source is
    read no further ahead of the ingest than that: a deeper queue would
    drain LiveSource's drop-oldest ring early, which defeats its overrun
    accounting, and would hold host memory without bound.

    A thread woken for every chunk slows a host that is busy the whole
    time (a replayed capture, every chunk ready): each wake takes the
    interpreter lock from the loop.  So once the queue has held a chunk
    at DEPTH + 1 checks in a row, the thread hands the source back and
    the loop pulls it itself; when two of those pulls in a row each keep
    the host off its CPU for _WAITED_S or more, the source is waiting
    again, and a new thread pulls the chunks after them.  close() stops
    a thread, which closes the source itself: a generator cannot be
    closed while another thread runs it."""

    def __init__(self, chunks):
        self._it = iter(chunks)
        self._held = deque()    # what a thread pulled before handing back
        self._ready = 0         # checks in a row that found a chunk ready
        self._waited = 0        # the loop's pulls in a row that waited
        self._thread = None
        self._start()

    def _start(self):
        self._q = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._closing = False
        self._thread = threading.Thread(target=self._pull,
                                        name="ingest-source", daemon=True)
        self._thread.start()

    def _pull(self):
        q, stop = self._q, self._stop
        try:
            for item in self._it:
                q.put(item)
                if stop.is_set():
                    return
            q.put(_END)
        except BaseException as e:     # re-raised by the loop
            q.put(_Raised(e))
        finally:
            if self._closing:
                self._close_source()

    def _close_source(self):
        close = getattr(self._it, "close", None)
        if close is not None:
            close()

    def _stop_thread(self):
        """Tell the thread to stop and free a put in progress: it then
        puts at most one more item without waiting, and pulls no more."""
        self._stop.set()
        try:
            self._held.append(self._q.get_nowait())
        except queue.Empty:
            pass

    def _hand_back(self):
        """Take the source back from the thread, after its pull in
        progress; what it pulled is served first."""
        self._stop_thread()
        self._thread.join()
        try:
            self._held.append(self._q.get_nowait())
        except queue.Empty:
            pass
        self._thread = None

    def _next(self):
        """The loop's own pull; the second in a row that waited starts a
        thread for the chunks after it."""
        t, cpu = time.perf_counter(), time.thread_time()
        try:
            item = next(self._it)
        except StopIteration:
            return _END
        except Exception as e:
            return _Raised(e)
        off_cpu = time.perf_counter() - t - (time.thread_time() - cpu)
        self._waited = self._waited + 1 if off_cpu >= _WAITED_S else 0
        if self._waited > 1:
            self._ready = self._waited = 0
            self._start()
        return item

    @property
    def waits(self) -> bool:
        """Whether the source has been keeping the loop waiting: a thread
        pulls it."""
        return self._thread is not None

    def get(self, block: bool):
        """The next item.  With `block` False, a check: raises
        queue.Empty if a thread pulls the source and has no chunk ready."""
        if self._held:
            return self._held.popleft()
        if self._thread is None:
            return self._next()
        if block:
            return self._q.get()
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            self._ready = 0
            raise
        self._ready += 1
        if self._ready > DEPTH:
            self._hand_back()
        return item

    def close(self):
        """Close the source: on its thread, after telling the thread to
        stop (and waiting for it at most _JOIN_S), or here."""
        if self._thread is None:
            self._close_source()
            return
        self._closing = True
        self._stop_thread()
        self._thread.join(_JOIN_S)


class PipelinedIngest:
    """Streaming loop over a FrontEnd: wire chunks in, BlockResults out.

    Chunks are interleaved (step_samples, 2) arrays of the wire dtype
    ((step_samples,) bytes for i4).  Conversion and the overlap carry run
    on the device, so per block the host link moves only the new wire
    bytes in and one packed int32 buffer out.

    The step (wire decode, carry, the front end's step, the packing) is
    one compiled step (utils/graph.py) on the front end's StepCache,
    built at the first run, as the JAX package jits _pipelined_step and
    _pack: on a card one graph replay per block.  Its static inputs are
    the carry, which the step's last operation overwrites with the next
    carry, and the chunk, into which each chunk's copy lands; its static
    output is the packed int32 vector, copied into a ring of DEPTH + 2
    preallocated host buffers straight after the replay, on the same
    stream.  A ring slot is reused only after its event has synchronized.
    The carry is this ingest's state, so it runs one stream at a time.

    When a block is handed out: at the latest when DEPTH + 1 later
    chunks have been handed in, finished or not.  While the source keeps
    the loop waiting, and a thread of its own (_Feed) pulls it one item
    ahead in a queue of one, also as soon as its event has completed
    (Event.query, no wait; one block per pass, oldest first), and when
    no chunk is ready, after waiting on the oldest pending block's event,
    since the host then has nothing else to do.  A source that waits for
    the air therefore holds no finished result back.  A source that
    stays ahead is pulled by the loop itself, which is then busy, and
    keeps DEPTH blocks in flight: handing out on completion there slowed
    short blocks.  An exception of the source reaches the consumer after
    the blocks before it, and closing the run closes the source.

    Each block opens the stages (utils/metrics.py) h2d, with its children
    ingest.slot_wait and ingest.stage, then device_step, then assemble,
    with its child ingest.result_wait, each once and in the order the
    blocks were handed over; a _Slip opens none.  So the j-th h2d and the
    j-th assemble of a stream belong to one block.  Counters: blocks,
    samples_in, classic_hits, le_hits, clock_slipped_slots, and
    ingest.early_release, the blocks handed out before the DEPTH rule
    would have handed them out, while the source still ran (the stream's
    last blocks, drained at its end, are not counted)."""

    def __init__(self, fe, wire: str = "f32"):
        if wire not in WIRES:
            raise ValueError(f"unknown wire format {wire!r}")
        self.fe = fe
        self.wire = wire
        self.chunk_shape = (fe.step_samples,) if wire == "i4" else \
            (fe.step_samples, 2)
        self.chunk_dtype = torch.from_numpy(np.zeros(0, WIRES[wire][0])).dtype
        self._step = None               # the CompiledStep, at first run
        self._specs = None              # the packed outputs' layout
        self._ring: list[_Slot] = []
        self._next = 0
        self._running = False

    def step(self, carry, new):
        """(device carry, device wire chunk) -> (next carry, the step's
        outputs), as the JAX package's _pipelined_step: the fused chain
        (FrontEnd.fused_step) for a polyphase bank, the conv-bank step
        (FrontEnd.device_step) for the odd rates' ChannelBank.  The eager
        body of the compiled step."""
        xb = torch.cat([carry, wire_decode(new, self.wire)], 1)
        fe = self.fe
        outs = fe.fused_step(xb) if fe.is_pfb else fe.device_step(xb)
        return xb[:, -fe.overlap_samples:], outs

    def _pack(self, outs):
        """Outputs -> one int32 device vector (float32 bit-cast), plus the
        specs that split it again on the host."""
        parts, specs = [], []
        for o in outs:
            if o is None:
                specs.append(None)
                continue
            specs.append((tuple(o.shape), "float32" if o.dtype ==
                          torch.float32 else "int32"))
            oi = o.view(torch.int32) if o.dtype == torch.float32 else \
                o.to(torch.int32)
            parts.append(oi.reshape(-1))
        return torch.cat(parts), specs

    def _graph_fn(self, carry, new):
        """The compiled step's body: step and _pack; its last operation
        writes the next carry into the static carry, after the cat has
        read it."""
        nxt, outs = self.step(carry, new)
        packed, self._specs = self._pack(outs)
        carry.copy_(nxt)
        return packed

    def _build(self, graph=None):
        """The compiled step, from zero inputs (`graph` as StepCache.build
        takes it: a graph on a CUDA device by default)."""
        fe = self.fe
        return fe.graphs.build(self._graph_fn, [
            torch.zeros((2, fe.overlap_samples), dtype=torch.float32,
                        device=fe.device),
            torch.zeros(self.chunk_shape, dtype=self.chunk_dtype,
                        device=fe.device)], graph)

    def _set_carry(self, host=None):
        """The static carry from host planes (2, overlap), or zeros (a
        stream's start without an initial carry, and a slip)."""
        carry = self._step.inputs[0]
        with self._step.on_stream():
            if host is None:
                carry.zero_()
            else:
                carry.copy_(torch.from_numpy(
                    np.ascontiguousarray(host, np.float32)))

    def _h2d(self, a, slot: _Slot):
        """Host wire chunk -> the step's static chunk, through the slot's
        (pinned) buffer and a non_blocking copy on the step's stream."""
        a = np.asarray(a)
        if a.shape != self.chunk_shape:
            raise ValueError(f"wire chunk must be {self.chunk_shape}, got "
                             f"{a.shape}")
        with metrics.stage("ingest.stage"):
            np.copyto(slot.chunk.numpy(), a)
        with self._step.on_stream():
            self._step.inputs[1].copy_(slot.chunk, non_blocking=True)

    def _launch(self, slot: _Slot):
        """Replay the step and start the copy of its packed outputs into
        the slot, on the step's stream."""
        with self._step.on_stream():
            packed = self._step.replay()[0]
            if slot.out is None:
                slot.out = torch.empty(packed.shape, dtype=torch.int32,
                                       pin_memory=slot.pin)
            slot.out.copy_(packed, non_blocking=True)
            if slot.event is not None:
                slot.event.record()

    def run(self, chunks, start_clkn: int = 0, initial_carry=None,
            bus=None):
        """Iterate BlockResults over a chunk stream.

        `chunks` yields wire arrays, or _Slip markers (from live_chunks)
        signalling dropped air time: the clock advances by the slipped
        slots, the device carry restarts from zeros, and `bus` (if
        given) gets a clock_slipped event.  While it keeps the loop
        waiting it is iterated on a thread of its own (_Feed); the run
        closes it when it ends.  One run at a time: iterating a second
        one while the first is open raises."""
        if self._running:
            raise RuntimeError("this ingest's carry holds one stream at a "
                               "time; finish or close the open one first")
        self._running = True
        try:
            yield from self._run(chunks, start_clkn, initial_carry, bus)
        finally:
            self._running = False

    def _run(self, chunks, start_clkn, initial_carry, bus):
        fe = self.fe
        if self._step is None:
            self._step = self._build()
            pin = fe.device.type == "cuda"
            self._ring = [_Slot(self.chunk_shape, self.chunk_dtype, pin)
                          for _ in range(DEPTH + 2)]
        self._set_carry(initial_carry)
        slot_base = start_clkn
        pending: deque = deque()        # [(slot, clkn)], oldest first
        feed = _Feed(chunks)
        try:
            while True:
                # one finished block per pass: the next chunk's copy to
                # the card then overlaps the hand-out of the block before
                if pending and feed.waits and pending[0][0].done():
                    yield self._release_early(pending)
                try:
                    item = feed.get(block=False)
                except queue.Empty:
                    if pending:
                        # no chunk to hand in: wait on the card, not the
                        # source
                        yield self._release_early(pending)
                        continue
                    item = feed.get(block=True)
                if item is _END:
                    break
                if isinstance(item, _Raised):
                    while pending:
                        yield self._assemble(*pending.popleft())
                    raise item.exc
                if isinstance(item, _Slip):
                    # gap in the stream: air time advanced without
                    # samples; packets straddling the gap are
                    # unrecoverable anyway
                    slot_base += item.slots
                    self._set_carry()
                    metrics.count("clock_slipped_slots", item.slots)
                    if bus is not None:
                        bus.emit("clock_slipped", slots=item.slots,
                                 samples=item.samples, clkn=slot_base)
                    continue
                slot = self._ring[self._next % len(self._ring)]
                self._next += 1
                with metrics.stage("h2d"):
                    with metrics.stage("ingest.slot_wait"):
                        slot.wait()
                    self._h2d(item, slot)
                if len(pending) > DEPTH:
                    yield self._assemble(*pending.popleft())
                with metrics.stage("device_step"):
                    self._launch(slot)
                pending.append((slot, slot_base))
                slot_base += fe.block_slots
                metrics.count("blocks", 1)
                metrics.count("samples_in", fe.step_samples)
            while pending:
                yield self._assemble(*pending.popleft())
        finally:
            feed.close()

    def _release_early(self, pending: deque):
        """The oldest pending block's result, handed out before the DEPTH
        rule would have (counted in ingest.early_release)."""
        metrics.count("ingest.early_release", 1)
        return self._assemble(*pending.popleft())

    def _assemble(self, slot: _Slot, slot_base: int):
        with metrics.stage("assemble"):
            with metrics.stage("ingest.result_wait"):
                slot.wait()
            # a copy: the slot is reused, and the result keeps its arrays
            buf = slot.out.numpy().copy()
            outs, pos = [], 0
            for spec in self._specs:
                if spec is None:
                    outs.append(None)
                    continue
                shape, dtype = spec
                n = int(np.prod(shape)) if shape else 1
                a = buf[pos: pos + n]
                if dtype == "float32":
                    a = a.view(np.float32)
                a = a.reshape(shape) if shape else a[0]
                outs.append(a)
                pos += n
            res = self.fe.assemble_block(*outs, slot_base=slot_base)
        metrics.count("classic_hits", len(res.hits))
        metrics.count("le_hits", len(res.le_hits))
        return res


def wire_chunks(samples, fe, wire: str = "f32", pad_tail: bool = False):
    """Split a host capture into (initial_carry, chunk iterator) matching
    the historical block placement: the capture's first overlap_samples
    seed the carry and each chunk is the next step_samples, so
    PipelinedIngest.run(...) yields the SAME blocks as fe.stream_sync.
    With pad_tail, a final zero-padded chunk covers the partial remainder
    (stream_sync's padded tail block)."""
    samples = np.asarray(samples)
    if np.iscomplexobj(samples):
        samples = np.stack([samples.real, samples.imag]).astype(np.float32)
    inter = wire_encode(samples, wire)
    ov, st = fe.overlap_samples, fe.step_samples
    n = inter.shape[0]
    if pad_tail:
        n_chunks = max(1, -(-(n - ov) // st)) if n > 0 else 0
    else:
        n_chunks = max(0, (n - ov) // st)
    total = ov + n_chunks * st
    if total > n:
        pad_shape = (total - n,) if wire == "i4" else (total - n, 2)
        # zero-LEVEL padding: for u8's offset format a 0x00 byte is
        # full-scale -1-1j, which would rail the tail block's energy
        inter = np.concatenate(
            [inter, np.full(pad_shape, WIRE_ZERO_BYTE[wire], inter.dtype)],
            axis=0)
    # carry holds the QUANTIZED values (what the device would have seen)
    carry = wire_decode_np(inter[:ov], wire)

    def chunks():
        for i in range(n_chunks):
            yield inter[ov + i * st: ov + (i + 1) * st]

    return carry, chunks()


def live_chunks(source, samples_per_slot: int):
    """Wrap a raw live source (LiveSource.iter_raw) into the chunk+slip
    stream PipelinedIngest.run consumes.

    Dropped samples are converted to whole slots (nearest; the sub-slot
    residual is carried so long-run clock drift is bounded by half a
    slot), keeping clkn locked to air time across overruns."""
    residual = 0

    def slip():
        nonlocal residual
        d = source.take_dropped_samples()
        if not d:
            return None
        residual += d
        slots = int(round(residual / samples_per_slot))
        residual -= slots * samples_per_slot
        return _Slip(slots=slots, samples=d) if slots else None

    for chunk in source.iter_raw():
        s = slip()
        if s is not None:
            yield s
        yield chunk
    s = slip()
    if s is not None:
        yield s
