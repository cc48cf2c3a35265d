"""[Frozen copy of gr_bluetooth_tpu_torch/core/le_tables.py.]
LE detection distance tables, generated from the valid-pattern sets.

Each table is the Hamming distance to the nearest member of a
spec-defined valid set; the reference hard-codes them
(lib/packet_impl.cc:1316-1444).  Copy of gr_bluetooth_tpu/core/le_tables.py
(the distance tables and the channel maps).

Valid sets (BLE spec Vol 6 Part B §2.3, §2.4):
  * 9-bit preamble+first-AA-bit: the two alternating patterns 0x155 / 0x0AA
  * advertising AA 0x8E89BED6, one 256-entry popcount table per byte
  * advertising header byte 0: PDU type 0..6, RFU bits 4-5 zero, and
    TxAdd == RxAdd (the reference's zero-distance set)
  * advertising header byte 1: length 6..36, RFU bits 6-7 zero
  * data header byte 0: LLID != 0 (bits 0-1), any NESN/SN/MD, bits 5-7 zero
  * data header byte 1: length 0..31, RFU bits 5-7 zero
"""
from __future__ import annotations

import numpy as np

from .constants import LE_ADV_AA

__all__ = ["LE_PREAMBLE_DISTANCE", "AA_DISTANCE", "ACCESS_HEADER_DISTANCE",
           "DATA_HEADER_DISTANCE", "LE_CHAN2INDEX", "LE_INDEX2CHAN",
           "freq2chan", "freq2index", "index2freq"]


def _min_distance_table(nbits: int, valid: np.ndarray) -> np.ndarray:
    vals = np.arange(1 << nbits, dtype=np.int64)
    d = np.full(1 << nbits, nbits, dtype=np.uint8)
    for v in valid:
        x = vals ^ v
        cnt = np.zeros(len(vals), dtype=np.uint8)
        for b in range(nbits):
            cnt += ((x >> b) & 1).astype(np.uint8)
        d = np.minimum(d, cnt)
    return d


def _build():
    preamble = _min_distance_table(9, np.array([0x155, 0x0AA]))

    aa_bytes = [(LE_ADV_AA >> (8 * k)) & 0xFF for k in range(4)]
    aa = np.stack([_min_distance_table(8, np.array([b])) for b in aa_bytes])

    adv_lsb_valid = np.array([t | (f << 6) for t in range(7) for f in (0, 3)])
    adv_msb_valid = np.arange(6, 37)
    acc = (_min_distance_table(8, adv_lsb_valid),
           _min_distance_table(8, adv_msb_valid))

    data_lsb_valid = np.array([x for x in range(0x20) if (x & 3) != 0])
    data_msb_valid = np.arange(0, 32)
    dat = (_min_distance_table(8, data_lsb_valid),
           _min_distance_table(8, data_msb_valid))
    return preamble, aa, acc, dat


(LE_PREAMBLE_DISTANCE, AA_DISTANCE, ACCESS_HEADER_DISTANCE,
 DATA_HEADER_DISTANCE) = _build()

# LE channel (0..39, at 2402+2k MHz) -> channel index (advertising 37/38/39
# interleaved); mirrors le_packet::chan2index (lib/packet_impl.cc:1295-1309)
LE_CHAN2INDEX = np.array(
    [37,
     0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
     38,
     11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
     27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
     39], dtype=np.int64)

# inverse map: channel index 0..39 -> LE channel 0..39 (2402 + 2k MHz)
LE_INDEX2CHAN = np.argsort(LE_CHAN2INDEX)


def freq2chan(freq: float) -> int:
    """LE channel for an absolute frequency; -1 if not on the LE grid.
    Mirrors le_packet::freq2chan (lib/packet_impl.cc:1285-1293)."""
    if 2402e6 <= freq <= 2480e6 and (freq % 2e6) < 5000.0:
        return int((freq - 2402e6) // 2e6)
    return -1


def freq2index(freq: float) -> int:
    ch = freq2chan(freq)
    return int(LE_CHAN2INDEX[ch]) if ch >= 0 else -1


def index2freq(index: int) -> float:
    """Absolute frequency of an LE channel index (0..39)."""
    return 2402e6 + 2e6 * int(LE_INDEX2CHAN[index])
