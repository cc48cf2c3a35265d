"""[Frozen copy of gr_bluetooth_tpu_torch/core/access_code.py.]
Classic BR access-code (sync word) codec — BT Core spec Vol 2 Part B §6.3.3.

A 72-symbol access code is, in air order (LSB-first transmission):

  air[0:4]    preamble  (1010 / 0101, extends the first sync bit)
  air[4:38]   34 BCH parity bits
  air[38:62]  LAP (24 bits, LSB first)
  air[62:68]  6-bit Barker extension selected by LAP bit 23
  air[68:72]  trailer   (1010 / 0101, extends the last sync bit)

The 64-bit sync word (air[4:68]) is the (64,30) expurgated-BCH systematic
codeword of info = (LAP ‖ barker) ⊕ PN, re-XORed with PN, with generator
polynomial g(D) (octal 260534236651) and PN = 0x83848D96BBCC54FC.

Because the whole construction is affine over GF(2) in the 24 LAP bits, we
also expose the affine form  ac_bits(LAP) = (A @ lap_bits + C) mod 2  with
A: (72, 24), C: (72,).  That form is what the TPU detector uses: it turns the
reference's per-offset sliding scan + codeword regeneration
(lib/packet_impl.cc:246-268,308-364,470-510: sniff_ac/acgen/lfsr/check_ac)
into one dense parity matmul over every offset at once.

The preamble/Barker Hamming-distance prefilter tables
(lib/packet_impl.cc:188-197) are generated here from first principles.
"""
from __future__ import annotations

import numpy as np

from .bits import host_to_air

__all__ = [
    "GEN_POLY", "PN64", "ac_bits", "affine_code", "check_ac", "sniff_ac",
    "preamble_distance_table", "barker_distance_table",
]

# generator polynomial g(D), bit j = coefficient of D^j (degree 34, monic)
GEN_POLY = 0o260534236651
_G_BITS = host_to_air(GEN_POLY, 35).astype(np.uint8)   # g[j] = D^j coeff

# 64-bit PN sequence p(D); air[4+j] carries bit j
PN64 = 0x83848D96BBCC54FC
_PN_AIR = host_to_air(PN64, 64).astype(np.uint8)

# Barker extensions (air[62:68]) per LAP bit 23
_BARKER_A23_1 = np.array([1, 1, 0, 0, 1, 0], dtype=np.uint8)
_BARKER_A23_0 = np.array([0, 0, 1, 1, 0, 1], dtype=np.uint8)


def _gf2_parity34(info_bits: np.ndarray) -> np.ndarray:
    """Remainder of info(D) * D^34 mod g(D); info bit i = coeff D^i, 30 bits."""
    # work on the 64-coefficient codeword c(D) = info(D) * D^34
    c = np.zeros(64, dtype=np.uint8)
    c[34:64] = info_bits
    for k in range(63, 33, -1):
        if c[k]:
            c[k - 34:k + 1] ^= _G_BITS
    return c[:34]


def ac_bits(lap: int) -> np.ndarray:
    """Full 72-bit access code in air order for a LAP."""
    lap_bits = host_to_air(lap, 24).astype(np.uint8)
    a23 = int(lap_bits[23])
    barker = _BARKER_A23_1 if a23 else _BARKER_A23_0
    info = np.concatenate([lap_bits, barker])          # air[38:68]
    d = info ^ _PN_AIR[34:64]
    parity = _gf2_parity34(d) ^ _PN_AIR[:34]           # air[4:38]
    air = np.empty(72, dtype=np.uint8)
    air[4:38] = parity
    air[38:62] = lap_bits
    air[62:68] = barker
    # preamble extends air[4] and trailer extends air[67], both alternating
    air[0:4] = (1, 0, 1, 0) if air[4] else (0, 1, 0, 1)
    air[68:72] = (0, 1, 0, 1) if air[67] else (1, 0, 1, 0)
    return air


def affine_code():
    """Affine form of ac_bits: (A, C) with ac_bits(lap) = (A @ l + C) % 2.

    A: (72, 24) uint8, C: (72,) uint8, l = LAP bits LSB-first.
    """
    C = ac_bits(0)
    A = np.empty((72, 24), dtype=np.uint8)
    for i in range(24):
        A[:, i] = ac_bits(1 << i) ^ C
    return A, C


_A_CACHE = None


def _affine_cached():
    global _A_CACHE
    if _A_CACHE is None:
        _A_CACHE = affine_code()
    return _A_CACHE


def check_ac(window: np.ndarray, max_errors: int = 6) -> tuple[bool, int, int]:
    """Validate a 68-symbol window as an access code.

    Reconstructs the code from the received LAP bits and counts bit errors
    over the first 68 symbols; accepts if errors <= max_errors (reference
    accepts < 7, lib/packet_impl.cc:470-510).  Returns (ok, lap, nerrors).
    """
    window = np.asarray(window, dtype=np.uint8)[:68]
    if window.shape[-1] < 68:
        return False, -1, 68
    A, C = _affine_cached()
    lap_bits = window[38:62]
    predicted = (A[:68] @ lap_bits.astype(np.int64) + C[:68]) & 1
    nerr = int((predicted.astype(np.uint8) ^ window).sum())
    lap = int((lap_bits.astype(np.int64) << np.arange(24)).sum())
    return nerr <= max_errors, lap, nerr


def preamble_distance_table() -> np.ndarray:
    """d(p, nearest valid 5-bit preamble+first-sync-bit), p in 0..31.

    Valid patterns are the two alternating sequences 01010/10101 (air order).
    Matches lib/packet_impl.cc:188-190.
    """
    t = np.empty(32, dtype=np.uint8)
    for i in range(32):
        t[i] = min(bin(i ^ 0b10101).count("1"), bin(i ^ 0b01010).count("1"))
    return t


def barker_distance_table() -> np.ndarray:
    """d(b, nearest valid 7-bit barker window air[61:68]), b in 0..127.

    The window covers LAP bit 23 plus the 6 Barker bits; the two valid values
    are 0x27 (a23=1) and 0x58 (a23=0).  Matches lib/packet_impl.cc:192-197.
    """
    t = np.empty(128, dtype=np.uint8)
    for i in range(128):
        t[i] = min(bin(i ^ 0x27).count("1"), bin(i ^ 0x58).count("1"))
    return t


def sniff_ac(stream: np.ndarray, limit: int, max_distance: int = 2,
             max_ac_errors: int = 6) -> int:
    """Find the first access code in a symbol stream; returns offset or -1.

    Host reference implementation mirroring classic_packet::sniff_ac
    (lib/packet_impl.cc:246-268): preamble+barker prefilter then full check.
    The TPU path (ops/detect.py) computes the same predicate densely.
    """
    stream = np.asarray(stream, dtype=np.uint8)
    pre_t = preamble_distance_table()
    bark_t = barker_distance_table()
    n = min(limit, len(stream) - 68)
    if n < 0:
        return -1
    for off in range(n + 1):
        w = stream[off:off + 68]
        pre = int((w[:5].astype(np.int64) << np.arange(5)).sum())
        bark = int((w[61:68].astype(np.int64) << np.arange(7)).sum())
        if pre_t[pre] + bark_t[bark] <= max_distance:
            ok, _, _ = check_ac(w, max_errors=max_ac_errors)
            if ok:
                return off
    return -1
