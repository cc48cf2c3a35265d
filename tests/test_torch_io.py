"""The port's host I/O against the JAX package's, on the same inputs.

  * io/sources.py: load_file for the three file formats, and the wire
    tables, equal to the JAX package's;
  * io/writers.py: PcapWriter's bytes equal to the JAX package's, on the
    native writer and the pure-Python one (time.time patched in both
    modules, so the timestamps are equal too);
  * io/native.py: the port's own build of native/btio.cc runs the drop-
    oldest ring through tests/test_native_ring.py's cases (byte-exact
    backpressure, newest-kept drop mode, concurrent conservation,
    LiveSource overrun accounting, an idle source that does not spin,
    the int4 wire, a LiveSource closed while the ingest's source thread
    waits in it); load() is None without a toolchain (the build
    itself is held in tests/test_torch_consts.py);
  * io/ingest.py's live half: live_chunks and PipelinedIngest.run over
    tests/test_ingest.py's FakeLiveSource chunks give the same clock
    slips, clock_slipped events, hits (clkn, channel, LAP) and recovered
    UAP as the JAX package's.
"""
import ctypes
import os
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from gr_bluetooth_tpu.io import ingest as jingest
from gr_bluetooth_tpu.io import sources as jsources
from gr_bluetooth_tpu.io import writers as jwriters
from gr_bluetooth_tpu.models.sniffer import Sniffer as JSniffer
from gr_bluetooth_tpu.testing import PiconetSim, make_piconet_capture
from gr_bluetooth_tpu.utils.log import EventBus as JBus
from gr_bluetooth_tpu_torch.io import ingest, native, sources, writers
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.utils.log import EventBus
from gr_bluetooth_tpu_torch.utils.metrics import Metrics
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

CAP = 1 << 20
FS, CENTER = 8e6, 2441e6
LAP, UAP = 0x24D952, 0x47


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, "g++ could not build the port's btio.cc"
    return lib


# --------------------------------------------------------------- sources

@pytest.mark.parametrize("fmt", ["cfile", "shorts", "bytes"])
@pytest.mark.parametrize("nsamples", [None, 1000])
def test_load_file_equals_jax(tmp_path, fmt, nsamples):
    r = np.random.default_rng(3)
    path = str(tmp_path / f"cap.{fmt}")
    if fmt == "cfile":
        (r.normal(size=4001) + 1j * r.normal(size=4001)).astype(
            np.complex64).tofile(path)
    else:
        dt = np.int16 if fmt == "shorts" else np.int8
        # an odd count: the torn final value is dropped
        r.integers(-100, 100, 2 * 4001 + 1).astype(dt).tofile(path)
    kw = dict(input_shorts=fmt == "shorts", nsamples=nsamples,
              input_bytes=fmt == "bytes")
    got = sources.load_file(path, **kw)
    want = jsources.load_file(path, **kw)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and np.array_equal(got, want)


def test_wire_tables_equal_jax():
    assert sources.WIRE_ITEMSIZE == jsources.WIRE_ITEMSIZE
    assert sources.WIRE_DTYPE == jsources.WIRE_DTYPE
    assert sources.WIRE_ZERO_BYTE == jsources.WIRE_ZERO_BYTE
    assert ingest.WIRES == jingest.WIRES
    # one definition each: the sources' tables are the ingest's
    assert sources.WIRE_ZERO_BYTE is ingest.WIRE_ZERO_BYTE


# --------------------------------------------------------------- writers

def _frames_of(writer_mod, path, use_native, monkeypatch):
    clock = iter(np.arange(1_700_000_000.125, 1_700_000_100, 0.25))
    monkeypatch.setattr(writer_mod.time, "time", lambda: float(next(clock)))
    r = np.random.default_rng(9)
    with writer_mod.PcapWriter(path, use_native=use_native) as w:
        for k in range(6):
            w.write_packet(r.integers(0, 256, 9 + 3 * k).astype(
                np.uint8).tobytes(), (0xBEEF << 32) | (0x47 << 24) | LAP)
            w.write_id(0x9E8B33 + k)
        n = w.n_written
    return Path(path).read_bytes(), n


@pytest.mark.parametrize("use_native", [True, False])
def test_pcap_bytes_equal_jax(tmp_path, monkeypatch, use_native):
    got, n = _frames_of(writers, str(tmp_path / "port.pcap"), use_native,
                        monkeypatch)
    want, nj = _frames_of(jwriters, str(tmp_path / "jax.pcap"), use_native,
                          monkeypatch)
    assert n == nj == 12
    assert got == want
    # the JAX package's native writer packs its header as six uint32s,
    # {magic, (2 << 16) | 4, 65535, 0, 0, dlt}, which read back as
    # version 4.2, thiszone 65535 and snaplen 0; the port matches it
    header = (4, 2, 65535, 0, 0) if use_native else (2, 4, 0, 0, 65535)
    assert struct.unpack("<IHHiIII", got[:24]) == (0xA1B2C3D4, *header, 1)
    # the first frame: dst = NAP:UAP:LAP, src 0, ether type 0xFFF0
    assert got[40:46] == ((0xBEEF << 32) | (0x47 << 24) | LAP).to_bytes(
        6, "big")
    assert got[46:52] == bytes(6) and got[52:54] == b"\xff\xf0"
    assert writers.ETHER_TYPE == jwriters.ETHER_TYPE == 0xFFF0


def test_native_pcap_records_equal_pure_python(tmp_path, monkeypatch, lib):
    """The two writers' records are equal byte for byte (their headers
    differ, as the JAX package's do: see above)."""
    a, _ = _frames_of(writers, str(tmp_path / "n.pcap"), True, monkeypatch)
    b, _ = _frames_of(writers, str(tmp_path / "p.pcap"), False, monkeypatch)
    assert a[24:] == b[24:] and a[:4] == b[:4] and a[20:24] == b[20:24]


# ------------------------------------------------------------ native ring

def _writer(fd: int, data: bytes, chunk: int = 1 << 16):
    for i in range(0, len(data), chunk):
        os.write(fd, data[i:i + chunk])
    os.close(fd)


def test_native_load_is_none_without_a_toolchain(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.load() is None


def test_ring_backpressure_stress_byte_exact(lib):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    rfd, wfd = os.pipe()
    t = threading.Thread(target=_writer, args=(wfd, data))
    t.start()
    ring = lib.bt_ring_create(rfd, CAP, 0)
    buf = ctypes.create_string_buffer(1 << 16)
    out = bytearray()
    sizes = rng.integers(1, 1 << 16, 4096).tolist()
    i = 0
    while True:
        n = lib.bt_ring_pop(ring, buf, sizes[i % len(sizes)])
        i += 1
        if n < 0:
            break
        out += buf.raw[:n]
    t.join()
    overruns = lib.bt_ring_overruns(ring)
    lib.bt_ring_destroy(ring)
    assert bytes(out) == data
    assert overruns == 0, "backpressure mode must never drop"


def test_ring_drop_mode_keeps_newest_exact(lib):
    rng = np.random.default_rng(2)
    total = 3 * CAP + 12345
    data = rng.integers(0, 256, total, dtype=np.uint8).tobytes()
    rfd, wfd = os.pipe()
    t = threading.Thread(target=_writer, args=(wfd, data))
    t.start()
    ring = lib.bt_ring_create(rfd, CAP, 1)
    t.join()
    deadline = time.time() + 10
    while time.time() < deadline:
        if lib.bt_ring_available(ring) + lib.bt_ring_dropped(ring) == total:
            break
        time.sleep(0.01)
    assert lib.bt_ring_available(ring) == CAP
    assert lib.bt_ring_dropped(ring) == total - CAP
    assert lib.bt_ring_overruns(ring) > 0
    buf = ctypes.create_string_buffer(CAP)
    got = bytearray()
    while True:
        n = lib.bt_ring_pop(ring, buf, CAP)
        if n <= 0:
            break
        got += buf.raw[:n]
    lib.bt_ring_destroy(ring)
    assert bytes(got) == data[-CAP:], "ring must keep the NEWEST samples"


def test_ring_drop_mode_concurrent_conservation(lib):
    total = 8 << 20
    data = np.arange(total // 8, dtype=np.uint64).tobytes()
    rfd, wfd = os.pipe()
    t = threading.Thread(target=_writer, args=(wfd, data))
    t.start()
    ring = lib.bt_ring_create(rfd, CAP, 1)
    buf = ctypes.create_string_buffer(1 << 14)
    out = bytearray()
    while True:
        n = lib.bt_ring_pop(ring, buf, 1 << 14)
        if n < 0:
            break
        if n == 0:
            time.sleep(0.0005)
            continue
        out += buf.raw[:n]
        time.sleep(0.0002)            # force the producer ahead
    t.join()
    dropped = lib.bt_ring_dropped(ring)
    assert lib.bt_ring_overruns(ring) > 0, "consumer never fell behind"
    lib.bt_ring_destroy(ring)
    assert len(out) + dropped == total, "bytes must be delivered or counted"
    arr = np.frombuffer(bytes(out), dtype=np.uint8)
    best = None
    for align in range(8):
        usable = (len(arr) - align) // 8 * 8
        words = arr[align:align + usable].view(np.uint64)
        valid = words < (total // 8)
        if best is None or valid.sum() > best[1]:
            best = (words, valid.sum())
    words, _ = best
    valid = words < (total // 8)
    both = valid[:-1] & valid[1:]
    assert (words[1:][both] > words[:-1][both]).mean() > 0.99


def test_live_source_pipe_overrun_bounded(lib):
    total_samples = (4 << 20) // 8
    iq = (np.random.default_rng(5).standard_normal(2 * total_samples)
          .astype(np.float32)).view(np.complex64).tobytes()
    rfd, wfd = os.pipe()
    t = threading.Thread(target=_writer, args=(wfd, iq))
    t.start()
    m = Metrics()
    src = sources.LiveSource(rfd, chunk_samples=4096, ring_mb=1, metrics=m)
    os.close(rfd)
    got = 0
    for i, chunk in enumerate(src):
        assert chunk.shape == (2, 4096)
        got += 4096
        if i < 20:
            time.sleep(0.002)         # fall behind early on
    t.join()
    assert src.overruns > 0, "consumer never fell behind"
    assert src.dropped_bytes > 0
    delivered = got * 8
    assert delivered + src.dropped_bytes <= len(iq)
    assert delivered + src.dropped_bytes > len(iq) - 4096 * 8
    assert m.snapshot()["counters"].get("samples_dropped", 0) == \
        src.dropped_bytes // 8
    src.close()


def test_idle_source_does_not_spin(lib):
    rfd, wfd = os.pipe()
    src = sources.LiveSource(rfd, chunk_samples=4096, ring_mb=1,
                             metrics=Metrics())
    os.close(rfd)
    got = []

    def consume():
        for chunk in src.iter_raw():
            got.append(chunk)

    t = threading.Thread(target=consume)
    c0 = time.process_time()
    w0 = time.time()
    t.start()
    time.sleep(1.0)                   # pipe stays empty: consumer idles
    cpu_idle = time.process_time() - c0
    wall = time.time() - w0
    assert cpu_idle < 0.25 * wall, (cpu_idle, wall)
    os.write(wfd, b"\0" * (4096 * 8))
    os.close(wfd)
    t.join(timeout=5)
    assert not t.is_alive()
    assert len(got) == 1 and got[0].shape == (4096, 2)
    src.close()


def test_live_source_i4_wire(lib):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 64 * 1024)) * 0.4).astype(np.float32)
    packed = ingest.wire_encode(x, "i4")
    assert np.array_equal(packed, jingest.wire_encode(x, "i4"))
    rfd, wfd = os.pipe()
    t = threading.Thread(target=_writer, args=(wfd, packed.tobytes()))
    t.start()
    src = sources.LiveSource(rfd, chunk_samples=4096, ring_mb=4, wire="i4")
    os.close(rfd)
    got = []
    for chunk in src.iter_raw():
        assert chunk.shape == (4096,) and chunk.dtype == np.uint8
        got.append(chunk)
    t.join()
    src.close()
    rec = ingest.wire_decode_np(np.concatenate(got), "i4")
    want = ingest.wire_decode_np(packed[: rec.shape[1]], "i4")
    assert np.array_equal(rec[:, : want.shape[1]], want)


def test_live_ingest_closed_while_its_source_waits(lib):
    """btrx --live stopping mid-stream: the consumer closes the run after
    two results while the ingest's source thread waits in the ring on a
    pipe gone silent but still open.  LiveSource.close() from this
    thread then destroys the ring only between two of that thread's
    pops; the source thread ends, and the counts read after close are
    the ring's."""
    fe = FrontEnd(4e6, 2441e6, block_slots=8, device="cpu")
    rfd, wfd = os.pipe()
    src = sources.LiveSource(rfd, fe.step_samples, ring_mb=4, wire="i16")
    os.close(rfd)
    data = np.zeros((3 * fe.step_samples, 2), np.int16).tobytes()
    w = threading.Thread(target=lambda: [
        os.write(wfd, data[i:i + (1 << 16)])
        for i in range(0, len(data), 1 << 16)])
    w.start()
    run = ingest.PipelinedIngest(fe, "i16").run(
        ingest.live_chunks(src, fe.samples_per_slot))
    assert [next(run).slot_base, next(run).slot_base] == [0, 8]
    run.close()
    w.join(timeout=5)
    assert not w.is_alive()
    feeds = [t for t in threading.enumerate() if t.name == "ingest-source"]
    # the ring's pump thread reads the pipe until its writer closes it,
    # and destroying the ring joins that thread
    closer = threading.Timer(0.3, os.close, (wfd,))
    closer.start()
    src.close()
    closer.join()
    for t in feeds:
        t.join(timeout=1)
        assert not t.is_alive()
    assert src.overruns == 0 and src.dropped_bytes == 0
    assert list(src.iter_raw()) == []


# ------------------------------------------------------- live ingest parity

class FakeLiveSource:
    """tests/test_ingest.py's scripted live source: chunk arrays, and
    ("drop", n_samples) entries that the ring would have dropped."""

    def __init__(self, items, itemsize):
        self.items = items
        self.itemsize = itemsize
        self._pending_drop = 0

    def iter_raw(self):
        for it in self.items:
            if isinstance(it, tuple):
                self._pending_drop += it[1]
            else:
                yield it

    def take_dropped_samples(self):
        d, self._pending_drop = self._pending_drop, 0
        return d


def _slip_rows(out, slip_cls):
    return [("slip", o.slots, o.samples) if isinstance(o, slip_cls)
            else ("chunk", o.shape) for o in out]


def test_live_chunks_slip_rounding():
    def items():
        return [np.zeros((8, 2), np.int16), ("drop", 2 * 625 + 200),
                np.zeros((8, 2), np.int16), ("drop", 500),
                np.zeros((8, 2), np.int16)]
    got = list(ingest.live_chunks(FakeLiveSource(items(), 4), 625))
    want = list(jingest.live_chunks(FakeLiveSource(items(), 4), 625))
    assert _slip_rows(got, ingest._Slip) == _slip_rows(want, jingest._Slip)
    slips = [o for o in got if isinstance(o, ingest._Slip)]
    assert [s.slots for s in slips] == [2, 1]
    assert sum(s.slots for s in slips) == round((2 * 625 + 700) / 625)


def test_overrun_advances_clock_and_sniffer_survives():
    """A mid-capture overrun of two blocks' air, through both packages'
    live ingest from the same scripted chunks: the same slip, the same
    clock_slipped events, the same hits (clkn, channel, LAP) on both
    sides of the gap, and the UAP recovered across it."""
    sim = PiconetSim(lap=LAP, uap=UAP, clk0=0x12780)
    n_slots = 512
    samples, sent = make_piconet_capture(sim, n_slots=n_slots, fs=FS,
                                         center_freq=CENTER, seed=6)
    fe_probe = FrontEnd(FS, CENTER, block_slots=8, device="cpu")
    st, ov = fe_probe.step_samples, fe_probe.overlap_samples
    spslot = fe_probe.samples_per_slot
    cut_lo, cut_hi = ov + 6 * st, ov + 8 * st
    x = np.stack([samples.real, samples.imag]).astype(np.float32)
    inter = np.ascontiguousarray(x.T)
    kept = np.concatenate([inter[:cut_lo], inter[cut_hi:]], axis=0)
    carry = np.ascontiguousarray(kept[:ov].T)
    chunks = []
    pos, blk = ov, 0
    while pos + st <= kept.shape[0]:
        if blk == 6:
            chunks.append(("drop", cut_hi - cut_lo))
        chunks.append(kept[pos:pos + st])
        pos += st
        blk += 1

    runs = {}
    for name, ing, sniffer, bus in (
            ("jax", jingest, lambda b: JSniffer(FS, CENTER, bus=b,
                                                enable_le=False,
                                                block_slots=8), JBus()),
            ("port", ingest, lambda b: Sniffer(FS, CENTER, bus=b,
                                               enable_le=False,
                                               block_slots=8, device="cpu"),
             EventBus())):
        mode = sniffer(bus)
        pipe = ing.PipelinedIngest(mode.fe, "f32")
        results = list(pipe.run(ing.live_chunks(FakeLiveSource(chunks, 8),
                                                spslot),
                                initial_carry=carry, bus=bus))
        mode.run_blocks(iter(results))
        pn = mode.basic_rate_piconets.get(LAP)
        runs[name] = dict(
            slips=bus.events("clock_slipped"),
            hits=[(h.clkn, h.channel, h.lap) for r in results
                  for h in r.hits],
            slot_bases=[r.slot_base for r in results],
            uap=None if pn is None or not pn.have_uap else pn.uap)
    j, t = runs["jax"], runs["port"]
    assert t["slips"] == j["slips"]
    assert [(e["slots"], e["samples"]) for e in t["slips"]] == \
        [(16, cut_hi - cut_lo)]
    assert t["slot_bases"] == j["slot_bases"]
    assert t["hits"] == j["hits"]
    assert t["uap"] == j["uap"] == UAP
    # clkn stays on air time after the gap (dropped air: slots 53..68)
    bank = set(fe_probe.bank.channels)
    after = {(s, c) for s, c, _ in sent if c in bank and 70 <= s < n_slots - 6}
    assert after and after <= {(c, ch) for c, ch, _ in t["hits"]}


def test_run_sends_nothing_to_the_device_for_a_slip(monkeypatch):
    """A _Slip moves the clock and restarts the compiled step's static
    carry from zeros on the device; _h2d sees only chunks, never the
    marker, and the carry is set at the start (zeros: no initial carry)
    and at the slip."""
    fe = FrontEnd(4e6, 2441e6, block_slots=8, device="cpu")
    pipe = ingest.PipelinedIngest(fe, "i16")
    seen = []
    h2d, set_carry = pipe._h2d, pipe._set_carry

    def spy(a, slot):
        assert not isinstance(a, ingest._Slip)
        seen.append(np.asarray(a).shape)
        return h2d(a, slot)

    def spy_carry(host=None):
        seen.append(("carry", host))
        set_carry(host)
        assert not pipe._step.inputs[0].any()

    monkeypatch.setattr(pipe, "_h2d", spy)
    monkeypatch.setattr(pipe, "_set_carry", spy_carry)
    chunk = np.zeros((fe.step_samples, 2), np.int16)
    bus = EventBus()
    res = list(pipe.run(iter([chunk, ingest._Slip(3, 3 * 2500), chunk]),
                        start_clkn=10, bus=bus))
    assert [r.slot_base for r in res] == [10, 10 + 8 + 3]
    assert bus.events("clock_slipped") == [
        {"kind": "clock_slipped", "slots": 3, "samples": 7500,
         "clkn": 10 + 8 + 3}]
    # the zero initial carry, chunk, the slip's zero carry, chunk
    assert seen == [("carry", None), chunk.shape, ("carry", None),
                    chunk.shape]
