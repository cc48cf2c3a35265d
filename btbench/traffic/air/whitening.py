"""[Frozen copy of gr_bluetooth_tpu_torch/core/whitening.py.]
Bluetooth data whitening (BT Core spec Vol 2 Part B §7.2; BLE Vol 6 Part B §3.2).

The whitening word is produced by the 7-bit LFSR g(D) = D^7 + D^4 + 1.  We
implement it in Galois form: state is 7 bits, output is the MSB, and when the
output is 1 the polynomial mask 0x11 is folded into the left-shifted state.

  * classic BR: state initialised to 0x40 | (CLK1-6)          (clock & 0x3f)
  * LE:         state initialised to bit-reversed channel index with a 1 in
                the LSB position: (rev6(index) << 1) | 1

Because the LFSR sequence is a 127-bit m-sequence, every init state is a phase
of one canonical cycle.  We precompute the cycle plus a 64-entry (classic) and
40-entry (LE) phase-index table at import time; whitening any span is then a
single modular gather — which is also the device-friendly formulation (the
cycle is a tiny constant table; indices are computed, not stored).

Parity: bit-exact with the reference's WHITENING_DATA / INDICES tables
(lib/packet_impl.cc:84-90,182-186,1446-1450).  Copy of
gr_bluetooth_tpu/core/whitening.py (classic and LE), held equal to it by
tests/test_torch_core.py.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "SEQUENCE", "CLASSIC_INDEX", "LE_INDEX", "whitening_word",
    "unwhiten", "unwhiten_many", "le_whitening_word",
]

_POLY_MASK = 0x11  # x^4 + 1 folded in when the x^7 term (MSB) pops out


def _galois_stream(init: int, n: int) -> np.ndarray:
    s = init
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        o = (s >> 6) & 1
        s = ((s << 1) & 0x7F) ^ (_POLY_MASK if o else 0)
        out[i] = o
    return out


def _rev6(x: int) -> int:
    return sum(((x >> i) & 1) << (5 - i) for i in range(6))


def _build():
    # canonical cycle: phase of the all-ones state (classic clock 63)
    cycle = _galois_stream(0x7F, 127)
    # identify a state with its next-7-outputs window (unique in an m-sequence)
    win_to_pos = {}
    ext = np.concatenate([cycle, cycle[:6]])
    for p in range(127):
        win_to_pos[tuple(ext[p:p + 7])] = p
    classic = np.empty(64, dtype=np.int64)
    for clk in range(64):
        classic[clk] = win_to_pos[tuple(_galois_stream(0x40 | clk, 7))]
    le = np.empty(40, dtype=np.int64)
    for idx in range(40):
        le[idx] = win_to_pos[tuple(_galois_stream(((_rev6(idx) << 1) | 1), 7))]
    return cycle, classic, le


SEQUENCE, CLASSIC_INDEX, LE_INDEX = _build()


_TILED: dict = {}      # length -> (127+length,) cyclic SEQUENCE buffer


def _tiled(length: int) -> np.ndarray:
    buf = _TILED.get(length)
    if buf is None:
        if len(_TILED) > 64:                    # lengths are config-bounded
            _TILED.clear()
        buf = np.resize(SEQUENCE, 127 + length)
        buf.setflags(write=False)               # shared cache: views too
        _TILED[length] = buf
    return buf


def whitening_word(clock, length: int, skip: int = 0) -> np.ndarray:
    """Whitening bits for CLK1-6 value(s) `clock`, starting `skip` bits in.

    `clock` may be scalar or an array of candidate clocks; output shape is
    clock.shape + (length,).  Matches classic_packet_impl::unwhiten's stream
    (lib/packet_impl.cc:512-526).

    The word is a cyclic slice of the 127-bit sequence, so rather than
    building a (K, length) int64 index tensor and gathering elementwise
    (the dominant cost of wide candidate batches — round-5 profile), the
    rows come from a sliding-window view over a tiled buffer: one uint8
    row copy per candidate."""
    clock = np.asarray(clock, dtype=np.int64)
    start = (CLASSIC_INDEX[clock & 0x3F] + skip) % 127
    buf = _tiled(length)
    win = np.lib.stride_tricks.sliding_window_view(buf, length)
    # array starts fancy-index (copy); a scalar start returns a READ-ONLY
    # view of the shared cache (buf is non-writable) — callers only XOR
    return win[start]


def le_whitening_word(index: int, length: int, skip: int = 0) -> np.ndarray:
    """Whitening bits for LE channel index (0..39). Ref: packet_impl.cc:1446-1450."""
    start = (int(LE_INDEX[index]) + skip) % 127
    return _tiled(length)[start: start + length]   # read-only cache view


def unwhiten(air_bits, clock, skip: int = 0) -> np.ndarray:
    """XOR a single air-order bit stream with the whitening word."""
    air_bits = np.asarray(air_bits, dtype=np.uint8)
    return air_bits ^ whitening_word(int(clock), air_bits.shape[-1], skip)


def unwhiten_many(air_bits, clocks, skip: int = 0) -> np.ndarray:
    """Unwhiten one stream under many candidate clocks at once.

    air_bits: (L,), clocks: (K,) -> (K, L).  This is the vectorized form of
    the reference's per-candidate loop (lib/piconet_impl.cc:457-463).
    """
    air_bits = np.asarray(air_bits, dtype=np.uint8)
    return air_bits[None, :] ^ whitening_word(np.asarray(clocks), air_bits.shape[-1], skip)
