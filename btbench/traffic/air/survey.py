"""The LAP survey's air: ID packets of seven LAPs on up to 24 channels.

A frozen copy, for the benchmark's yardstick, of chip_smoke.py's survey plan (LAPS, _classic_plan)
(gr_bluetooth_tpu_torch).  It imports nothing of the port; later
changes to the port leave it as it is.
"""
from __future__ import annotations

import numpy as np

from . import synth
from .access_code import ac_bits
from .constants import SYMBOLS_PER_SLOT

LAPS = (0x24D952, 0x9E8B33, 0x123456, 0xABCDEF, 0x5A17EC, 0x000F0F,
        0xC0FFEE)


def _classic_plan(fe, n_slots: int, r, busy: set):
    """ID packets (72-symbol access code + 60 random symbols) of LAPS on
    up to 24 of the bank's channels, the first and last among them, four
    packets per slot on different channels."""
    ch_all = fe.bank.channels
    pick = np.unique(np.linspace(0, len(ch_all) - 1,
                                 min(24, len(ch_all))).round().astype(int))
    chans = [ch_all[i] for i in pick]
    sps = fe.bank.sps
    plan, planted = [], []
    for i in range(5 * len(chans)):
        ch = chans[i % len(chans)]
        slot = 1 + ((i // 4) * 11) % (n_slots - 3)
        if {(ch, slot - 1), (ch, slot), (ch, slot + 1)} & busy:
            continue
        busy.add((ch, slot))
        lap = LAPS[i % len(LAPS)]
        bits = np.concatenate([ac_bits(lap)[:72],
                               r.integers(0, 2, 60).astype(np.uint8)])
        start = (slot * SYMBOLS_PER_SLOT + int(r.integers(0, 400))) * sps
        plan.append(synth.PlannedPacket(channel=ch, start_sample=start,
                                        bits=bits))
        planted.append((lap, ch, slot))
    return plan, planted
