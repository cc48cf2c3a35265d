"""[Frozen copy of gr_bluetooth_tpu_torch/core/crc.py.]
Bluetooth BR CRC-16 and HEC — encode, check, and UAP recovery.

CRC-16 (spec Vol 2 Part B §7.1.2, CRC-CCITT reflected form): the register is
seeded with the bit-reversed UAP in its upper byte and consumes air-order
payload bits; matches classic_packet::crcgen (lib/packet_impl.cc:528-548).

HEC (spec §7.1.1): 8-bit code over the 10 header bits, seeded with the UAP.
The reference only implements the *reverse* direction — running the HEC LFSR
backwards over the header bits to recover the UAP from a received HEC
(UAP_from_hec, lib/packet_impl.cc:596-609, Ossmann's attack).  We provide
both directions (forward HEC is needed by the synthesizer/encoder).

Everything is vectorized over leading batch axes (e.g. 64 candidate clocks at
once — the reference's per-candidate loop at lib/piconet_impl.cc:457-496).
"""
from __future__ import annotations

import numpy as np

from .bits import reverse8

__all__ = [
    "crc16", "crc16_states", "payload_crc_ok", "hec_forward", "uap_from_hec",
]


def _crc_step(reg: np.ndarray, b) -> np.ndarray:
    """One bit step of the UAP-seeded CRC-CCITT LFSR (reflected form)."""
    reg = (reg >> 1) | (((reg & 1) ^ (b & 1)) << 15)
    reg ^= (reg & 0x8000) >> 5
    reg ^= (reg & 0x8000) >> 12
    return reg


# GF(2) linearization tables (built lazily, grown on demand):
#   _G[m]   : final register contribution of a single input 1-bit that is
#             followed by m zero-input steps
#   _H[L,j] : final register contribution of seed register bit 8+j (the
#             bit-reversed UAP byte) after L input steps
#   _T[v]   : per-byte composite, reg' = (reg >> 8) ^ _T[(reg ^ byte) & 0xFF]
# so crc16 collapses to one vectorized XOR-reduce over the bit stream
# instead of an L-iteration Python loop (L is up to ~2700 for DM5).
_G = np.array([int(_crc_step(np.uint16(0), np.uint16(1)))], np.uint16)
_H = np.array([[1 << (8 + j) for j in range(8)]], np.uint16)
_T: np.ndarray | None = None


def _grow_tables(L: int) -> None:
    global _G, _H
    while len(_G) < L or len(_H) < L + 1:
        _G = np.concatenate([_G, _crc_step(_G[-1:], np.uint16(0))])
        _H = np.concatenate([_H, _crc_step(_H[-1:], np.uint16(0))])


def _byte_table() -> np.ndarray:
    global _T
    if _T is None:
        reg = np.zeros(256, dtype=np.uint16)
        for i in range(8):
            reg = _crc_step(reg, (np.arange(256, dtype=np.uint16) >> i))
        # f(v_low, byte=0) == f(0, byte=v): the input bit XORs with reg
        # bit 0, so low-byte register bits and input bits enter identically
        _T = reg
    return _T


def crc16(air_bits: np.ndarray, uap) -> np.ndarray:
    """CRC-16 over air-order bits with UAP-seeded register.

    air_bits: (..., L) uint8; uap: scalar or (...) broadcastable.
    Returns (...) uint16 register value (compared against the 16 bits
    following the payload, themselves read LSB-first).

    The LFSR is GF(2)-affine in (seed, input bits), so the register after
    L steps is the XOR of each input bit's precomputed influence plus the
    evolved seed — one vectorized XOR-reduce instead of an L-step loop.
    """
    air_bits = np.asarray(air_bits, dtype=np.uint16) & 1
    L = air_bits.shape[-1]
    _grow_tables(L)
    uapr = reverse8(np.asarray(uap)).astype(np.uint16)
    ub = (uapr[..., None] >> np.arange(8, dtype=np.uint16)) & 1
    seed = np.bitwise_xor.reduce(ub * _H[L], axis=-1)
    if L == 0:
        return np.broadcast_to(seed, air_bits.shape[:-1]).copy()
    data = np.bitwise_xor.reduce(air_bits * _G[L - 1::-1], axis=-1)
    return (data ^ seed).astype(np.uint16)


def crc16_ragged(air_bits: np.ndarray, lengths, uap) -> np.ndarray:
    """crc16 over per-row prefixes of different lengths, in one pass.

    air_bits: (K, Lmax); lengths: (K,) bits consumed per row; uap: (K,).
    A bit's influence on the final register depends only on its distance
    to the END of the stream, so aligning each row's bits at the end
    (one take_along_axis) turns the ragged batch into a single
    XOR-reduce — the serial crc16_states chain cost ~0.6 ms per batched
    ACL group where this is ~10 us."""
    air_bits = np.asarray(air_bits, dtype=np.uint16) & 1
    K, Lmax = air_bits.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    _grow_tables(Lmax)
    m = np.arange(Lmax, dtype=np.int64)
    idx = lengths[:, None] - 1 - m[None, :]
    rev = np.take_along_axis(air_bits, np.clip(idx, 0, Lmax - 1), axis=1)
    rev = rev & (idx >= 0)
    data = np.bitwise_xor.reduce(rev * _G[:Lmax], axis=-1)
    uapr = reverse8(np.asarray(uap)).astype(np.uint16)
    ub = (uapr[..., None] >> np.arange(8, dtype=np.uint16)) & 1
    seed = np.bitwise_xor.reduce(ub * _H[lengths], axis=-1)
    return (data ^ seed).astype(np.uint16)


def crc16_states(air_bits: np.ndarray, uap) -> np.ndarray:
    """CRC register value after every byte (8 bits) of the stream.

    air_bits: (..., 8*n) -> (..., n+1) uint16, states[..., k] = CRC of the
    first k bytes.  This turns the reference's O(L^2) EV3/EV5 byte-length
    scans (lib/packet_impl.cc:884-913, 970-999) into a single O(L) pass —
    table-driven per byte (the prefix states form a serial chain, so the
    per-bit loop collapses 8x rather than fully).
    """
    air_bits = np.asarray(air_bits, dtype=np.uint16) & 1
    nbytes = air_bits.shape[-1] // 8
    w8 = (1 << np.arange(8, dtype=np.uint16))
    byts = (air_bits[..., : nbytes * 8].reshape(air_bits.shape[:-1] +
                                                (nbytes, 8)) * w8).sum(-1)
    T = _byte_table()
    out = np.empty(air_bits.shape[:-1] + (nbytes + 1,), dtype=np.uint16)
    reg = (reverse8(np.asarray(uap)).astype(np.uint16) << 8) & 0xFF00
    reg = np.broadcast_to(reg, air_bits.shape[:-1]).copy()
    out[..., 0] = reg
    for k in range(nbytes):
        reg = (reg >> 8) ^ T[(reg ^ byts[..., k]) & 0xFF]
        out[..., k + 1] = reg
    return out


def payload_crc_ok(payload_bits: np.ndarray, uap) -> np.ndarray:
    """Check trailing CRC: payload_bits = (..., 8*n) with last 16 bits = CRC.

    Mirrors classic_packet_impl::payload_crc (lib/packet_impl.cc:677-686).
    """
    payload_bits = np.asarray(payload_bits, dtype=np.uint8)
    data = payload_bits[..., :-16]
    crc = crc16(data, uap)
    w = (1 << np.arange(16, dtype=np.int64))
    check = (payload_bits[..., -16:].astype(np.int64) * w).sum(axis=-1)
    return crc.astype(np.int64) == check


def hec_forward(header_bits10: np.ndarray, uap) -> np.ndarray:
    """Forward HEC of 10 air-order header bits, seeded with UAP.

    Inverse of uap_from_hec (verified by round-trip test); returns the 8-bit
    HEC as transmitted (air_to_host of the 8 HEC bits).
    """
    header_bits10 = np.asarray(header_bits10, dtype=np.uint16)
    x = reverse8(np.asarray(uap)).astype(np.uint16)
    x = np.broadcast_to(x, header_bits10.shape[:-1]).copy()
    # invert the backward recursion of uap_from_hec, stepping i = 0..9
    for i in range(10):
        d = header_bits10[..., i]
        b7 = (x & 1) ^ (d & 1)
        x = (x >> 1) | (b7 << 7)
        x ^= b7 * 0x65
    return x.astype(np.uint8)


def _uap_from_hec_lfsr(hdr_data, hec) -> np.ndarray:
    """Backward HEC LFSR (lib/packet_impl.cc:596-609) — reference form,
    used to build the lookup tables below."""
    hdr_data = np.asarray(hdr_data, dtype=np.uint16)
    hec = np.asarray(hec, dtype=np.uint16)
    hec = np.broadcast_to(hec, np.broadcast(hdr_data, hec).shape).copy()
    hdr_data = np.broadcast_to(hdr_data, hec.shape)
    for i in range(9, -1, -1):
        hec ^= ((hec & 0x80) >> 7) * 0x65
        hec = ((hec << 1) & 0xFF) | (((hec >> 7) ^ (hdr_data >> i)) & 1)
    return reverse8(hec)


_UAP_TABLES: tuple | None = None


def uap_from_hec(hdr_data, hec) -> np.ndarray:
    """Recover the UAP by running the HEC LFSR backwards over the header.

    hdr_data: (...) 10-bit ints (air_to_host of header bits 0..9);
    hec: (...) 8-bit ints.  The recovery is GF(2)-affine in the 18 input
    bits, so it collapses to two table gathers + XOR (this sits on the
    sniffer's per-packet header-verify hot path as well as the 64-candidate
    clock attack).
    """
    global _UAP_TABLES
    if _UAP_TABLES is None:
        th = _uap_from_hec_lfsr(np.arange(1024, dtype=np.uint16), 0)
        te = _uap_from_hec_lfsr(0, np.arange(256, dtype=np.uint16))
        c = _uap_from_hec_lfsr(0, 0)
        _UAP_TABLES = (th, te, c)
    th, te, c = _UAP_TABLES
    h = np.asarray(hdr_data, dtype=np.int64)
    e = np.asarray(hec, dtype=np.int64)
    return th[h] ^ te[e] ^ c
