"""The control of the correctness check: the plain reference put in the
program's place and computed one precision below the configuration's
(TF32 matmuls where the configuration states float32 with TF32 off),
judged by the same numbers as a run, on the same pass of the same seed.
"""
from __future__ import annotations

import numpy as np

from ..reference.frontend import RefFrontEnd
from ..traffic.generator import block_planes, load_traffic, make_pass
from .check import _hit_diff

__all__ = ["control_numbers"]


def control_numbers(sp, seed: int, device="cuda") -> dict:
    """hit_mismatch and snr_gap_db of the control against the reference
    over every block position of the seed's pass (a run weighs each
    position by the blocks it saw; the control's numbers are per pass)."""
    cfg = sp.config
    tr = load_traffic(sp.traffic_path)
    ref = RefFrontEnd(cfg["sample_rate"], cfg["center_freq"],
                      squelch_db=cfg["squelch_db"],
                      block_slots=cfg["block_slots"],
                      max_ac_errors=cfg["max_ac_errors"],
                      enable_le=cfg["enable_le"], device=device)
    p = make_pass(tr, cfg, seed, step_samples=ref.step_samples,
                  overlap_samples=ref.overlap_samples,
                  samples_per_slot=ref.samples_per_slot,
                  block_slots=ref.block_slots)
    hit_mis, gap = 0, 0.0
    for k in range(p.n_blocks):
        x = block_planes(p, k, ref.step_samples, ref.overlap_samples)
        outs = {}
        for control in (False, True):
            snr, tab, n, le_tab, n_le = ref.step(x, control=control)
            outs[control] = (np.asarray(snr, np.float64),
                          *ref.hits(tab, n, le_tab, n_le))
        (s0, c0, l0), (s1, c1, l1) = outs[False], outs[True]
        hit_mis += _hit_diff(c0, c1) + _hit_diff(l0, l1)
        gap = max(gap, float(np.abs(s0 - s1).max()))
    return dict(hit_mismatch=hit_mis, snr_gap_db=gap)
