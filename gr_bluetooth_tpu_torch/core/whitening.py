"""Bluetooth LE data whitening (BLE Vol 6 Part B §3.2).

The whitening word is produced by the 7-bit LFSR g(D) = D^7 + D^4 + 1 in
Galois form: state is 7 bits, output is the MSB, and when the output is
1 the polynomial mask 0x11 is folded into the left-shifted state.  For
LE the state starts at the bit-reversed channel index with a 1 in the
LSB position: (rev6(index) << 1) | 1.

The LFSR sequence is a 127-bit m-sequence, so every start state is a
phase of one canonical cycle; whitening any span is a slice of the
cycle repeated.

The LE part of gr_bluetooth_tpu/core/whitening.py (the classic-clock
whitening comes with the modes, ROADMAP.md).  Bit-exact with the
reference's WHITENING_DATA / INDICES tables (lib/packet_impl.cc:1446-1450).
"""
from __future__ import annotations

import numpy as np

__all__ = ["SEQUENCE", "LE_INDEX", "le_whitening_word"]

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
    # canonical cycle: phase of the all-ones state
    cycle = _galois_stream(0x7F, 127)
    # identify a state with its next-7-outputs window (unique in an m-sequence)
    ext = np.concatenate([cycle, cycle[:6]])
    win_to_pos = {tuple(ext[p:p + 7]): p for p in range(127)}
    le = np.array([win_to_pos[tuple(_galois_stream((_rev6(i) << 1) | 1, 7))]
                   for i in range(40)], dtype=np.int64)
    return cycle, le


SEQUENCE, LE_INDEX = _build()


def le_whitening_word(index: int, length: int, skip: int = 0) -> np.ndarray:
    """Whitening bits for LE channel index (0..39), starting `skip` bits
    in.  Ref: packet_impl.cc:1446-1450."""
    start = (int(LE_INDEX[index]) + skip) % 127
    return np.resize(SEQUENCE, 127 + length)[start: start + length]
