"""LE link-layer primitives: CRC-24 and Channel Selection Algorithm #1.

New capability relative to the reference: its low_energy_piconet is an empty
stub (lib/piconet_impl.cc:551-585) and its LE packet layer neither checks nor
generates the CRC (le_packet decode_* stubs, lib/packet_impl.cc:1571-1579).
A CONNECT_REQ it *dissects* (AA, CRCInit, ChM, Hop — lib/packet_impl.cc:
1581-1665) carries everything needed to follow the connection; this module
supplies the two missing algorithms (spec v4.2 Vol 6 Part B §3.1.1 CRC and
§4.5.8.2 channel selection), vectorized numpy like core/hop.py.

Conventions (spec §1.2/§3.1.1): data bits enter the CRC LFSR in air order
(LSB first); the register is preset with CRCInit (position 0 = LSB; 0x555555
on advertising channels); the 24 CRC bits are transmitted MSB first
(position 23 down to 0).
"""
from __future__ import annotations

import numpy as np

__all__ = ["crc24", "crc24_bits", "crc24_ok", "used_channels",
           "csa1_next_unmapped", "csa1_channel", "csa1_sequence",
           "csa2_channel_identifier", "csa2_channel", "csa2_sequence"]

_CRC24_POLY = 0x00065B  # feedback taps incl. position 0 (x^24+x^10+x^9+x^6+x^4+x^3+x+1)
ADV_CRC_INIT = 0x555555


def _crc24_table() -> np.ndarray:
    """Byte-at-a-time table: clocking 8 bits B (first bit = MSB of B)
    advances the register as ((reg << 8) & 0xFFFFFF) ^ T[(reg >> 16) ^ B].
    """
    t = np.zeros(256, dtype=np.int64)
    for x in range(256):
        r = x << 16
        for _ in range(8):
            fb = (r >> 23) & 1
            r = ((r << 1) & 0xFFFFFF) ^ (fb * _CRC24_POLY)
        t[x] = r
    return t


_T24 = _crc24_table()
_T24_LIST = _T24.tolist()                 # python ints for the scalar path
_MSB_W = (1 << np.arange(7, -1, -1, dtype=np.int64))


def crc24(air_bits: np.ndarray, init) -> np.ndarray:
    """LE CRC-24 register after consuming air-order bits.

    air_bits: (..., L) {0,1}; init: broadcastable CRCInit value(s).
    Returns (...) int64 register value.

    Byte-table driven (the bit-at-a-time LFSR cost ~200 us per ~300-bit
    PDU in numpy-scalar overhead — the dominant host cost of a busy LE
    channel); scalar inputs additionally run on python ints."""
    air_bits = np.asarray(air_bits, dtype=np.int64)
    L = air_bits.shape[-1]
    nb, tail = L // 8, L % 8
    if air_bits.ndim == 1 and np.isscalar(init) or (
            air_bits.ndim == 1 and getattr(init, "ndim", 0) == 0):
        bits = air_bits.tolist()
        reg = int(init)
        for k in range(nb):
            b = 0
            for s in range(8):
                b = (b << 1) | bits[8 * k + s]
            reg = ((reg << 8) & 0xFFFFFF) ^ _T24_LIST[((reg >> 16) & 0xFF)
                                                      ^ b]
        for i in range(nb * 8, L):
            fb = ((reg >> 23) & 1) ^ bits[i]
            reg = ((reg << 1) & 0xFFFFFF) ^ (fb * _CRC24_POLY)
        return np.int64(reg)
    reg = np.broadcast_to(np.asarray(init, dtype=np.int64),
                          air_bits.shape[:-1]).copy()
    if nb:
        by = (air_bits[..., : nb * 8]
              .reshape(air_bits.shape[:-1] + (nb, 8)) * _MSB_W).sum(-1)
        for k in range(nb):
            reg = ((reg << 8) & 0xFFFFFF) ^ _T24[((reg >> 16) & 0xFF)
                                                 ^ by[..., k]]
    for i in range(nb * 8, L):
        fb = ((reg >> 23) & 1) ^ (air_bits[..., i] & 1)
        reg = ((reg << 1) & 0xFFFFFF) ^ (fb * _CRC24_POLY)
    return reg


def crc24_bits(air_bits: np.ndarray, init) -> np.ndarray:
    """The 24 CRC bits as transmitted (MSB of the register first)."""
    reg = crc24(air_bits, init)
    sh = np.arange(23, -1, -1, dtype=np.int64)
    return ((np.asarray(reg)[..., None] >> sh) & 1).astype(np.uint8)


def crc24_ok(pdu_and_crc_bits: np.ndarray, init) -> np.ndarray:
    """Validate a received (header+payload+CRC) dewhitened bit stream."""
    bits = np.asarray(pdu_and_crc_bits)
    data, rx = bits[..., :-24], bits[..., -24:]
    want = crc24_bits(data, init)
    return (rx == want).all(axis=-1)


# ------------------------------------------------------------------ CSA#1

def used_channels(ch_map: int) -> np.ndarray:
    """Sorted array of used data-channel indices from the 37-bit ChM field."""
    ch = np.arange(37, dtype=np.int64)
    return ch[((np.int64(ch_map) >> ch) & 1) == 1]


def csa1_next_unmapped(last_unmapped, hop_increment) -> np.ndarray:
    """unmappedChannel = (lastUnmapped + hopIncrement) mod 37 (§4.5.8.2)."""
    return (np.asarray(last_unmapped, dtype=np.int64) +
            np.asarray(hop_increment, dtype=np.int64)) % 37


def csa1_channel(unmapped, ch_map: int) -> np.ndarray:
    """Remap an unmapped channel through the used-channel map."""
    unmapped = np.asarray(unmapped, dtype=np.int64)
    used = used_channels(ch_map)
    if len(used) == 0:
        raise ValueError("channel map has no used channels")
    in_map = ((np.int64(ch_map) >> unmapped) & 1) == 1
    remapped = used[unmapped % len(used)]
    return np.where(in_map, unmapped, remapped)


def csa1_sequence(first_unmapped: int, hop_increment: int, ch_map: int,
                  n_events: int) -> np.ndarray:
    """Data-channel index for connection events 0..n_events-1.

    Event 0 uses unmapped = (first_unmapped + hop) mod 37, i.e.
    `first_unmapped` is the state *before* the first event (0 at connection
    setup per §4.5.8.2: lastUnmappedChannel is 0 for the first event).
    """
    ev = np.arange(1, n_events + 1, dtype=np.int64)
    unmapped = (first_unmapped + ev * hop_increment) % 37
    return csa1_channel(unmapped, ch_map)


# ----------------------------------------------- CSA #2 (BT 5.0 §4.5.8.3)
#
# BT5 connections/periodic advertising negotiate Channel Selection
# Algorithm #2 (ChSel bit in the advertising PDU header): a per-event PRN
# seeded by the access address replaces CSA#1's linear hop.  The reference
# predates BT5 entirely (its LE piconet is a stub); this extends
# LowEnergyPiconet.predict_channel beyond parity.  Vectorized over event
# counters like the rest of this module.

def _csa2_perm(v: np.ndarray) -> np.ndarray:
    """The PERM operation: reverse the bits within each byte of a u16."""
    v = ((v & 0xAAAA) >> 1) | ((v & 0x5555) << 1)
    v = ((v & 0xCCCC) >> 2) | ((v & 0x3333) << 2)
    return ((v & 0xF0F0) >> 4) | ((v & 0x0F0F) << 4)


def _csa2_mam(a: np.ndarray, b) -> np.ndarray:
    """The MAM (multiply-add-modulo) operation: (17*a + b) mod 2^16."""
    return (17 * a + b) & 0xFFFF


def csa2_channel_identifier(aa: int) -> int:
    """channelIdentifier = AA[31:16] XOR AA[15:0]."""
    aa = int(aa) & 0xFFFFFFFF
    return ((aa >> 16) ^ (aa & 0xFFFF)) & 0xFFFF


def csa2_prn_e(counter, channel_identifier: int) -> np.ndarray:
    """Per-event pseudo-random number prn_e (§4.5.8.3.3, fig 4.44)."""
    ci = np.int64(channel_identifier)
    prn = (np.asarray(counter, dtype=np.int64) & 0xFFFF) ^ ci
    for _ in range(3):
        prn = _csa2_mam(_csa2_perm(prn), ci)
    return prn ^ ci


def csa2_channel(counter, aa: int, ch_map: int) -> np.ndarray:
    """Data channel index for connection event `counter` under CSA#2.

    unmapped = prn_e mod 37; if unused, remap via
    remappingIndex = floor(N * prn_e / 2^16) into the sorted used list.
    """
    used = used_channels(ch_map)
    n = len(used)
    if n == 0:
        raise ValueError("channel map has no used channels")
    prn_e = csa2_prn_e(counter, csa2_channel_identifier(aa))
    unmapped = prn_e % 37
    in_map = ((np.int64(ch_map) >> unmapped) & 1) == 1
    remap_idx = (n * prn_e) >> 16
    return np.where(in_map, unmapped, used[remap_idx])


def csa2_sequence(aa: int, ch_map: int, n_events: int,
                  start: int = 0) -> np.ndarray:
    """Channel indices for event counters start..start+n_events-1."""
    ev = np.arange(start, start + n_events, dtype=np.int64)
    return csa2_channel(ev, aa, ch_map)
