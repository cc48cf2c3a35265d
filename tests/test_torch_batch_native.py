"""core/batch_decode's native pass (native/batch_decode.cc) against the
numpy form it replaced (_decode_known_rows_numpy) and the JAX package's
decode_known_rows: equal row dicts, key for key, with the same value
types, dtypes and shapes, on every batched type and failure, DV voice,
the deferred types, narrow matrices (the zero pad, the clipped FEC block
count and payload width), K = 0 and 1, the UAP attack's 64-clock
candidate batch and a seeded fuzz of mixed valid and corrupted packets.
A Sniffer run with the native pass gives the events of a run forced
onto the numpy form, and counts every batched row as native."""
import numpy as np
import pytest

from gr_bluetooth_tpu.core import batch_decode as jbatch
from gr_bluetooth_tpu.core import packets as jpackets
from gr_bluetooth_tpu_torch import testing
from gr_bluetooth_tpu_torch.core import batch_decode, fec, packets
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.utils.log import EventBus
from gr_bluetooth_tpu_torch.utils.metrics import metrics
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

LAP, UAP, CLOCK = 0x24D952, 0x47, 0x2A
BATCHED = (0, 1, 3, 4, 8, 9, 10, 11, 14, 15)
DEFERRED = (2, 5, 6, 7, 12, 13)
FEC_TYPES = (3, 8, 10, 14)
HB2_TYPES = (10, 11, 14, 15)
PAYLOAD = {0: b"", 1: b"", 3: bytes(range(5)), 4: bytes(range(20)),
           8: b"dv-data", 9: b"AUX1-payload", 10: bytes(range(100)),
           11: bytes(range(150)), 14: bytes(range(200)),
           15: bytes(range(250)), 5: bytes(range(10)),
           6: bytes(range(20)), 7: bytes(range(25)), 12: bytes(range(90)),
           13: bytes(range(160))}
MAX_USER = {3: 17, 4: 27, 8: 9, 9: 29, 10: 121, 11: 183, 14: 224, 15: 339}
WIDTH = 3200


def _same(a, b):
    """Equal values of the same types (arrays: dtype, shape, elements)."""
    if isinstance(a, dict):
        return type(b) is dict and a.keys() == b.keys() and \
            all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return type(b) is list and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and \
            a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _decode_all(bits, sizes, clocks, uaps):
    """The native rows, held equal to the numpy form's and the JAX
    package's; the native pass must have taken every row."""
    before = metrics.counters.get("batch_decode.native_rows", 0)
    got = batch_decode.decode_known_rows(bits, sizes, clocks, uaps)
    assert metrics.counters.get("batch_decode.native_rows", 0) - before \
        == len(bits)
    ref = batch_decode._decode_known_rows_numpy(bits, sizes, clocks, uaps)
    jref = jbatch.decode_known_rows(bits, sizes, clocks, uaps)
    for k, (g, r, j) in enumerate(zip(got, ref, jref)):
        assert _same(g, r), (k, g, r)
        assert _same(r, j), (k, r, j)
    assert len(got) == len(ref) == len(jref) == len(bits)
    return got


def _args(rows, sizes, clocks=CLOCK, uaps=UAP, width=WIDTH):
    sym = np.zeros((len(rows), width), np.uint8)
    for k, r in enumerate(rows):
        n = min(len(r), width)
        sym[k, :n] = r[:n]
    K = len(rows)
    return (sym, np.asarray(sizes, np.int64),
            np.broadcast_to(np.asarray(clocks, np.int64), (K,)).copy(),
            np.broadcast_to(np.asarray(uaps, np.int64), (K,)).copy())


def _encode(t, payload=None, clock=CLOCK, uap=UAP, lap=LAP):
    if t == 2:
        return packets.encode_fhs_packet(lap, uap, 0xBEEF, clock=clock,
                                         clk27_value=0x123456)
    voice = bytes(range(10, 20)) if t == 8 else b""
    b = packets.encode_classic_packet(
        lap, uap, clock, t, PAYLOAD[t] if payload is None else payload,
        voice_bytes=voice)
    if t == 9:
        # AUX1 goes out with no CRC, but its length field, read as every
        # type's, counts two bytes more: 16 symbols more make it in range
        b = np.concatenate([b, np.zeros(16, np.uint8)])
    return b


def _uncorrectable():
    """A two-bit error that no FEC 2/3 block corrects (the code is
    linear, so one pattern fails every codeword)."""
    for i in range(15):
        for j in range(i + 1, 15):
            e = np.zeros(15, np.uint8)
            e[[i, j]] = 1
            if not fec.fec23_decode_blocks(e[None])[1][0]:
                return e
    raise AssertionError("every two-bit error corrects")


def _off(t):
    return 126 + (80 if t == 8 else 0)


def _need_hdr(t):
    return (30 if t in HB2_TYPES else 15) if t in FEC_TYPES else \
        (16 if t in HB2_TYPES else 8)


def _faulty(t, fault):
    """(bits, size) of type t with one fault planted."""
    b = _encode(t).copy()
    size, off = len(b), _off(t)
    if fault == "hec":
        b[72:126] ^= 1                       # every header triple flipped
    elif t in (0, 1):
        pass                                 # no payload to fault
    elif fault == "payload_header":
        if t in FEC_TYPES:
            b[off:off + 15] ^= _uncorrectable()
        else:
            size = off + _need_hdr(t) - 1
    elif fault == "range":
        size = off + 40
    elif fault == "payload_fec":
        if t in FEC_TYPES:
            b[off + 45:off + 60] ^= _uncorrectable()      # block 3
        else:
            b[off + 8 * 3 + 5] ^= 1
    elif fault == "crc":
        if t in FEC_TYPES:
            b[off + 45:off + 60] ^= fec.fec23_encode(
                np.eye(10, dtype=np.uint8)[4])            # a codeword
        else:
            b[off + 8 * 3 + 5] ^= 1
    return b, size


FAULTS = ("none", "hec", "payload_header", "range", "payload_fec", "crc")


def test_the_library_loads():
    """g++ is part of the test toolchain: the native pass must build, or
    every comparison below would hold numpy to itself."""
    assert batch_decode._load() is not None


@pytest.mark.parametrize("t", BATCHED)
def test_each_batched_type_and_fault(t):
    """Clean, HEC, payload header, range, payload FEC and CRC faults of
    one type in one batch, and each row alone."""
    cases = [_faulty(t, f) for f in FAULTS]
    rows = _decode_all(*_args([c[0] for c in cases], [c[1] for c in cases]))
    for c in cases:
        _decode_all(*_args([c[0]], [c[1]]))
    got = dict(zip(FAULTS, rows))
    assert got["none"]["ok"] and got["hec"]["header_failed"]
    if t in (0, 1):
        return
    assert got["none"]["crc_ok"] is (None if t == 9 else True)
    assert got["payload_header"]["fail"] == "hdr"
    assert got["range"]["fail"] == "range"
    if t in FEC_TYPES:
        assert got["payload_fec"]["fail"] == "payload_fec"
    bad_crc = got["crc"]
    assert bad_crc["ok"] and bad_crc["crc_ok"] is (None if t == 9 else False)
    if t == 8:
        assert all("voice" in r for r in rows[2:])


def test_every_type_and_fault_in_one_batch():
    cases = [_faulty(t, f) for t in BATCHED + DEFERRED for f in FAULTS]
    _decode_all(*_args([c[0] for c in cases], [c[1] for c in cases]))


def test_deferred_types_and_dv_voice():
    rows = [_encode(t) for t in DEFERRED + (8,)]
    short_dv = _encode(8)
    got = _decode_all(*_args(rows + [short_dv],
                             [len(r) for r in rows] + [126 + 79]))
    assert got[:len(DEFERRED)] == [None] * len(DEFERRED)
    dv, short = got[len(DEFERRED)], got[-1]
    assert dv["ok"] and dv["voice"].dtype == np.uint8 and \
        dv["voice"].shape == (80,)
    assert "voice" not in short and short["fail"] == "hdr"


@pytest.mark.parametrize("width", [126, 150, 200, 235])
def test_narrow_rows_take_the_zero_pad(width):
    """A matrix narrower than the ACL rows' payload offset + 30 symbols:
    the numpy form pads it with zeros, the native pass reads zeros past
    it.  Rows of size 126 to the width, and rows whose sizes run past
    it, so that the padded symbols are decoded."""
    rng = np.random.default_rng(width)
    rows, sizes = [], []
    for t in (3, 4, 8, 9, 10, 11, 14, 15, 0, 2):
        b = _encode(t)
        for hi in (width, width, len(b) + 40):
            rows.append(b)
            sizes.append(int(rng.integers(126, hi + 1)))
    _decode_all(*_args(rows, sizes, width=width))


@pytest.mark.parametrize("width", [240, 300, 450, 700, 1300])
def test_narrow_matrix_clips_blocks_and_width(width):
    """Long packets whose sizes run past the matrix: the FEC block count
    and the payload width clip at the matrix's edge, batch-wide."""
    rows = [_encode(t) for t in (14, 15, 10, 11, 8, 3, 4)]
    got = _decode_all(*_args(rows, [len(r) for r in rows], width=width))
    clipped = [r for r in got if r["ok"] and
               r["payload"].size < 8 * r["payload_length"]]
    assert clipped or width == 1300


def test_k0_and_k1():
    assert _decode_all(*_args([], [])) == []
    for t in BATCHED:
        b = _encode(t)
        (row,) = _decode_all(*_args([b], [len(b)]))
        assert row["ok"]


@pytest.mark.parametrize("t", [3, 10, 14, 4, 11, 15, 8, 0, 2])
def test_64_clock_candidate_batch(t):
    """The batch core/packets.crc_check_clocks builds: one packet under
    all 64 CLK1-6 candidates, with their UAPs from the header."""
    sym = _encode(t, clock=0x1D)
    n = len(sym)
    base = packets.ClassicPacket(symbols=sym.copy())
    uaps, types, fec_ok = base.try_clocks(np.arange(64))
    assert fec_ok
    wide = np.zeros((64, max(n + (n + 1) // 2 + 16, 236)), np.uint8)
    wide[:, :n] = sym[None, :]
    rows = _decode_all(wide, np.full(64, n), np.arange(64, dtype=np.int64),
                       np.asarray(uaps, np.int64))
    assert rows[0x1D] is None if t == 2 else rows[0x1D]["ok"]
    got = packets.crc_check_clocks(packets.ClassicPacket(symbols=sym.copy()),
                                   list(range(64)), uaps.tolist(),
                                   types.tolist())
    want = jpackets.crc_check_clocks(
        jpackets.ClassicPacket(symbols=sym.copy()), list(range(64)),
        uaps.tolist(), types.tolist())
    assert got == want


def _fuzz_batch(rng, K, width):
    rows, sizes, clocks, uaps = [], [], [], []
    for _ in range(K):
        t = int(rng.choice(BATCHED + BATCHED + DEFERRED))
        clock = int(rng.integers(0, 1 << 27))
        uap = int(rng.integers(0, 256))
        payload = None
        if t in MAX_USER:
            payload = rng.integers(0, 256, int(rng.integers(
                0, MAX_USER[t] + 3))).astype(np.uint8).tobytes()
        b = _encode(t, payload, clock=clock, uap=uap,
                    lap=int(rng.integers(0, 1 << 24))).copy()
        tail = rng.integers(0, 2, 400).astype(np.uint8)
        b = np.concatenate([b, tail])        # junk past the packet
        size = len(b) - len(tail)
        u = rng.random()
        if u < 0.25:                         # scattered bit errors
            idx = rng.integers(72, size, int(rng.integers(1, 7)))
            b[idx] ^= 1
        elif u < 0.3:                        # a burst
            s = int(rng.integers(72, size))
            b[s:s + 12] ^= 1
        u = rng.random()
        if u < 0.15:
            size = int(rng.integers(100, size + 1))
        elif u < 0.2:
            size += int(rng.integers(1, 400))
        u = rng.random()
        if u < 0.1:
            clock += int(rng.integers(1, 64))
        elif u < 0.15:
            uap ^= int(rng.integers(1, 256))
        rows.append(b)
        sizes.append(size)
        clocks.append(clock)
        uaps.append(uap)
    return _args(rows, sizes, clocks, uaps, width=width)


def _outcome(r):
    if r is None:
        return "deferred"
    if r.get("header_failed"):
        return "header_failed"
    if not r["ok"]:
        return r["fail"]
    return f"crc_{r.get('crc_ok')}"


def test_seeded_fuzz_of_mixed_batches():
    """2,560 rows in 40 batches of 64: every batched and deferred type,
    valid and corrupted, truncated and overlong, wrong clocks and UAPs,
    in matrices of the sniffer's width and narrower."""
    rng = np.random.default_rng(20261018)
    seen: dict = {}
    n = 0
    for i in range(40):
        width = WIDTH if i % 4 else int(rng.integers(236, 1500))
        got = _decode_all(*_fuzz_batch(rng, 64, width))
        n += len(got)
        for r in got:
            o = _outcome(r)
            seen[o] = seen.get(o, 0) + 1
    assert n >= 2000
    assert set(seen) == {"deferred", "header_failed", "hdr", "range",
                         "payload_fec", "crc_True", "crc_False",
                         "crc_None"}, seen


SIMS = [testing.PiconetSim(lap=LAP, uap=UAP, clk0=0x12780),
        testing.PiconetSim(lap=0x1A2B3C, uap=0x99, clk0=0x00450),
        testing.PiconetSim(lap=0x654321, uap=0x13, clk0=0x71111)]


@pytest.mark.parametrize("make,n_slots",
                         [("make_multi_piconet_capture", 512),
                          ("make_hostile_capture", 1024)])
def test_sniffer_events_native_equal_numpy(monkeypatch, make, n_slots):
    """The same capture through Sniffer with the native pass and forced
    onto the numpy form (the loader patched to find no library): equal
    events and decoded packets; every batched row went native."""
    fs, center = 4e6, 2441e6
    x, _ = getattr(testing, make)(SIMS, n_slots=n_slots, fs=fs,
                                  center_freq=center, seed=7)

    def run():
        c0 = dict(metrics.counters)
        sn = Sniffer(fs, center, block_slots=16, enable_le=False,
                     bus=EventBus(), device="cpu")
        sn.run(x)
        counts = {k: metrics.counters.get(k, 0) - c0.get(k, 0)
                  for k in ("batch_decode.rows", "batch_decode.native_rows",
                            "sniffer.batch_rows")}
        decoded = [(p.lap, p.uap, p.clkn, p.channel, p.packet_type,
                    p.payload_length,
                    None if p.payload is None else p.payload.tobytes())
                   for p in sn.decoded]
        return sn.bus.events(), decoded, counts

    ev, dec, counts = run()
    assert counts["sniffer.batch_rows"] > 0
    assert counts["batch_decode.native_rows"] == counts["batch_decode.rows"]
    monkeypatch.setattr(batch_decode, "_load", lambda: None)
    ev_np, dec_np, counts_np = run()
    assert counts_np["batch_decode.native_rows"] == 0
    assert counts_np["batch_decode.rows"] == counts["batch_decode.rows"]
    assert dec == dec_np and len(dec) > 10
    assert ev == ev_np


def test_a_matrix_narrower_than_the_header_raises():
    with pytest.raises(ValueError, match="bits must be"):
        batch_decode.decode_known_rows(np.zeros((2, 125), np.uint8),
                                       [125, 125], [0, 0], [UAP, UAP])
    with pytest.raises(ValueError):
        batch_decode.decode_known_rows(np.zeros((2, 300), np.uint8),
                                       [300], [0, 0], [UAP, UAP])
    with pytest.raises(ValueError, match="bits must be"):
        batch_decode.decode_known_rows(np.zeros((2, 300), np.uint8),
                                       [300], [0], [UAP])
