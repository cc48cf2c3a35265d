"""[Frozen copy of gr_bluetooth_tpu_torch/core/hop.py.]
Bluetooth 79-channel basic hop-selection kernel (spec Vol 2 Part B §2.6).

The reference materializes the entire 2^27-slot channel sequence (~134 MB)
plus a 2 MB perm5 lookup table per piconet (gen_hops/precalc,
lib/piconet_impl.cc:96-255).  The TPU-native design inverts that: the hop is
a cheap closed-form bit-manipulation function of (clock, address), so we
evaluate it *lazily and vectorized* over millions of candidate clocks —
winnowing becomes a masked reduction with zero table memory.  A torch
variant for on-device winnowing lives in ops/hop_ops.py.  Copy of
gr_bluetooth_tpu/core/hop.py.

Clock convention: `clk` below is the slot clock CLK1-27 (625 us units), i.e.
the index the reference uses into d_sequence (comment "sequence index =
clock >> 1", lib/piconet_impl.cc:222-226); the spec's CLK includes the
312.5 us half-slot bit CLK0, so spec_clk = clk << 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import ALIASED_CHANNELS, CHANNELS, SEQUENCE_LENGTH

__all__ = [
    "AddressConsts", "address_precalc", "perm5", "single_hop_raw", "hop",
    "aliased_channel", "init_candidates", "winnow", "hop_sequence_block",
]

# butterfly wiring of perm5, spec §2.6.3 (also lib/piconet_impl.cc:182-183)
_IDX1 = np.array([0, 2, 1, 3, 0, 1, 0, 3, 1, 0, 2, 1, 0, 1])
_IDX2 = np.array([1, 3, 2, 4, 4, 3, 2, 4, 4, 3, 4, 3, 3, 2])

# frequency register bank: channel = bank[k] = (2k) mod 79
_BANK = np.array([(i * 2) % CHANNELS for i in range(CHANNELS)], dtype=np.int32)


@dataclass(frozen=True)
class AddressConsts:
    """Address-derived constants a1/b/c1/d1/e of §2.6 (piconet_impl.cc:150-168)."""
    a1: int
    b: int
    c1: int
    d1: int
    e: int


def address_precalc(address: int) -> AddressConsts:
    """address = (UAP << 24 | LAP) & 0xfffffff; lower 28 bits of BD_ADDR."""
    a1 = (address >> 23) & 0x1F
    b = (address >> 19) & 0x0F
    c1 = (((address >> 4) & 0x10) | ((address >> 3) & 0x08) |
          ((address >> 2) & 0x04) | ((address >> 1) & 0x02) | (address & 0x01))
    d1 = (address >> 10) & 0x1FF
    e = (((address >> 7) & 0x40) | ((address >> 6) & 0x20) |
         ((address >> 5) & 0x10) | ((address >> 4) & 0x08) |
         ((address >> 3) & 0x04) | ((address >> 2) & 0x02) |
         ((address >> 1) & 0x01))
    return AddressConsts(a1, b, c1, d1, e)


def perm5(z, p_high, p_low):
    """Vectorized 5-bit butterfly permutation (spec §2.6.3).

    z: 5-bit value(s); p_high: 5 bits; p_low: 9 bits.  All numpy-broadcast.
    Replaces the reference's 2 MB precomputed d_perm_table
    (lib/piconet_impl.cc:143-146,179-211) with direct evaluation: 14
    conditional bit swaps are cheap on a vector unit.
    """
    z = np.asarray(z, dtype=np.int64)
    p = (np.asarray(p_low, dtype=np.int64) |
         (np.asarray(p_high, dtype=np.int64) << 9))
    shape = np.broadcast(z, p).shape
    zb = [np.broadcast_to((z >> i) & 1, shape).copy() for i in range(5)]
    for i in range(13, -1, -1):
        ctrl = (p >> i) & 1
        j, k = _IDX1[i], _IDX2[i]
        a, bbit = zb[j], zb[k]
        zb[j] = np.where(ctrl == 1, bbit, a)
        zb[k] = np.where(ctrl == 1, a, bbit)
    out = zb[0]
    for i in range(1, 5):
        out = out | (zb[i] << i)
    return out


def single_hop_raw(spec_clk, ac: AddressConsts):
    """Channel for spec clock value(s) CLK0-27 (piconet_impl.cc:259-276)."""
    clk = np.asarray(spec_clk, dtype=np.int64)
    x = (clk >> 2) & 0x1F
    y1 = (clk >> 1) & 0x01
    y2 = y1 << 5
    a = (ac.a1 ^ (clk >> 21)) & 0x1F
    c = (ac.c1 ^ (clk >> 16)) & 0x1F
    d = (ac.d1 ^ (clk >> 7)) & 0x1FF
    f = (clk >> 3) & 0x1FFFFF0
    perm = perm5(((x + a) % 32) ^ ac.b, (y1 * 0x1F) ^ c, d)
    return _BANK[(perm + ac.e + f + y2) % CHANNELS]


def hop(clk, ac: AddressConsts, afh: bool = False):
    """Channel for slot clock(s) CLK1-27.

    afh=True reproduces gen_hops' AFH mode where odd slots reuse the even
    slot's channel (lib/piconet_impl.cc:241-247).
    """
    clk = np.asarray(clk, dtype=np.int64) & (SEQUENCE_LENGTH - 1)
    if afh:
        clk = clk & ~np.int64(1)
    return single_hop_raw(clk << 1, ac)


def aliased_channel(channel):
    """Observable channel (26..50) in aliased-USRP2 mode (piconet_impl.cc:520-523)."""
    return ((np.asarray(channel, dtype=np.int64) + 24) % ALIASED_CHANNELS) + 26


def _observable(ch, aliased: bool):
    return aliased_channel(ch) if aliased else ch


def init_candidates(channel: int, known_clk6: int, ac: AddressConsts,
                    aliased: bool = False, afh: bool = False,
                    block: int = 1 << 22) -> np.ndarray:
    """All CLK1-27 values matching the first observation, given CLK1-6.

    Lazy equivalent of piconet_impl.cc:285-302 — evaluates the hop kernel
    over the 2^21 clocks congruent to known_clk6 mod 64, in blocks, and
    keeps those whose (optionally aliased) channel matches.
    """
    out = []
    clocks = np.arange(known_clk6 & 0x3F, SEQUENCE_LENGTH, 64, dtype=np.int64)
    for s in range(0, len(clocks), block):
        c = clocks[s:s + block]
        ch = _observable(hop(c, ac, afh), aliased)
        out.append(c[ch == channel])
    return np.concatenate(out) if out else np.empty(0, dtype=np.int64)


def winnow(candidates: np.ndarray, offset: int, channel: int,
           ac: AddressConsts, aliased: bool = False,
           afh: bool = False) -> np.ndarray:
    """Keep candidates whose hop at (candidate+offset) matches the observation.

    Masked-reduction equivalent of piconet_impl.cc:305-338.
    """
    c = (candidates + offset) & (SEQUENCE_LENGTH - 1)
    ch = _observable(hop(c, ac, afh), aliased)
    return candidates[ch == channel]


def hop_sequence_block(start: int, length: int, ac: AddressConsts,
                       afh: bool = False) -> np.ndarray:
    """Materialize a span of the hop sequence (for tests / hop following)."""
    clk = np.arange(start, start + length, dtype=np.int64)
    return hop(clk, ac, afh)
