"""On-device CLK1-27 hop winnowing (torch twin of core/hop.py).

The port of gr_bluetooth_tpu/ops/hop_ops.py, whose DeviceWinnower is XLA
elementwise code, not a Pallas kernel; here it is torch int32
elementwise code on an explicit device.

The reference materializes the full 2^27-slot hop sequence per piconet
(~134 MB; gen_hops, lib/piconet_impl.cc:214-255) and winnows candidate
clocks against it with sequential scans (init_candidates/winnow,
lib/piconet_impl.cc:285-338).  Here:

  * the candidate set is a device-resident boolean mask over the 2^21
    clocks congruent to CLK1-6 mod 64 — 2 MB instead of 134 MB;
  * init and each winnow evaluate the §2.6 hop kernel (int32 bit
    operations) at (candidate + offset) for all 2^21 clocks and AND the
    channel match into the mask;
  * the only per-winnow host traffic is the surviving count (one
    scalar); candidate values cross once, when the set is small enough
    for the host numpy tail (core/hop.winnow).

Used by models/piconet.py above a size threshold; core/hop.py is the
reference (tests/test_torch_hop_ops.py holds the two equal).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import ALIASED_CHANNELS, CHANNELS, SEQUENCE_LENGTH
from ..core.hop import _IDX1, _IDX2, address_precalc
from ..utils.device import resolve_device

__all__ = ["DeviceWinnower", "hop_channels"]

_GRID = SEQUENCE_LENGTH // 64          # 2^21 clocks congruent mod 64


def _perm5(z, p):
    """5-bit butterfly permutation (spec §2.6.3) on int32 tensors: the
    14 conditional bit swaps of core/hop.perm5, each as an XOR swap of
    bits j and k masked by control bit i of p."""
    zb = [(z >> i) & 1 for i in range(5)]
    for i in range(13, -1, -1):
        j, k = int(_IDX1[i]), int(_IDX2[i])
        t = (zb[j] ^ zb[k]) & ((p >> i) & 1)
        zb[j] = zb[j] ^ t
        zb[k] = zb[k] ^ t
    out = zb[0]
    for i in range(1, 5):
        out = out | (zb[i] << i)
    return out


def hop_channels(clk, a1: int, b: int, c1: int, d1: int, e: int,
                 afh: bool = False):
    """Channel for slot clocks CLK1-27 (int32 tensor); the twin of
    core/hop.hop (closed form of lib/piconet_impl.cc:259-276)."""
    clk = clk & (SEQUENCE_LENGTH - 1)
    if afh:
        clk = clk & ~1                  # odd slot reuses the even channel
    spec = clk << 1                     # CLK0 appended; fits int32 (2^28)
    x = (spec >> 2) & 0x1F
    y1 = (spec >> 1) & 0x01
    a = ((spec >> 21) ^ a1) & 0x1F
    c = ((spec >> 16) ^ c1) & 0x1F
    d = ((spec >> 7) ^ d1) & 0x1FF
    f = (spec >> 3) & 0x1FFFFF0
    z = ((x + a) & 31) ^ b
    p = d | (((y1 * 0x1F) ^ c) << 9)
    perm = _perm5(z, p)
    # bank[k] = (2k) % 79, so the register-bank gather folds into arithmetic
    return (2 * (perm + e + f + (y1 << 5))) % CHANNELS


class DeviceWinnower:
    """Device-resident CLK1-27 candidate set for one piconet.

    Equivalent to core/hop.init_candidates followed by core/hop.winnow
    chains; candidate values leave the device only through candidates().
    `device` as for the port's entry points: None means the CUDA card,
    and raises when there is none."""

    def __init__(self, address: int, known_clk6: int, channel: int,
                 aliased: bool = False, afh: bool = False, device=None):
        self.device = resolve_device(device)
        ac = address_precalc(address)
        self._consts = (ac.a1, ac.b, ac.c1, ac.d1, ac.e)
        self.base = int(known_clk6) & 0x3F
        self.aliased = bool(aliased)
        self.afh = bool(afh)
        self._clocks = self.base + (torch.arange(
            _GRID, dtype=torch.int32, device=self.device) << 6)
        self.mask = torch.ones(_GRID, dtype=torch.bool, device=self.device)
        self.count = self.winnow(0, channel)

    def winnow(self, offset: int, channel: int) -> int:
        """AND one (offset, channel) observation into the mask; returns the
        surviving count (the only host transfer)."""
        ch = hop_channels(self._clocks + int(offset), *self._consts,
                          afh=self.afh)
        if self.aliased:
            ch = (ch + 24) % ALIASED_CHANNELS + 26
        self.mask &= ch == int(channel)
        self.count = int(self.mask.sum())
        return self.count

    def candidates(self) -> np.ndarray:
        """Surviving clock values on the host (int64, sorted)."""
        idx = torch.nonzero(self.mask).reshape(-1).cpu().numpy()
        return self.base + (idx.astype(np.int64) << 6)
