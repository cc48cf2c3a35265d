"""LE access-address detection over dense symbol rows.

The port of the LE half of gr_bluetooth_tpu/ops/detect.py
(_le_dewhiten_header_bits, le_row_consts, _le_detect_batch_impl): for
every offset of every LE row, the Hamming distances of the 9-bit
preamble (+ first AA bit), of the dewhitened 16-bit header and, on the
advertising rows, of the access address to their valid sets, looked up
in the generated tables (core/le_tables.py; the tables the reference
hard-codes, lib/packet_impl.cc:1316-1444).  The reference slides one
offset at a time (sniff_aa, lib/packet_impl.cc:1452-1527).

Torch code: the JAX package computes it outside any Pallas kernel.
Field values are integers built from shifted bit slices; the table
lookups take int64 indices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import whitening
from ..core.le_tables import (AA_DISTANCE, ACCESS_HEADER_DISTANCE,
                              DATA_HEADER_DISTANCE, LE_PREAMBLE_DISTANCE)

__all__ = ["le_detect_batch", "le_row_consts", "le_table_consts"]


def _le_dewhiten_header_bits(index: int) -> np.ndarray:
    """Whitening word covering symbols 40..55 (the 16 header bits)."""
    return whitening.le_whitening_word(index, 16, skip=0).astype(np.float32)


def le_row_consts(indices) -> tuple:
    """Per-row constants for le_detect_batch: (white (R,16) float32,
    aa_on (R,1) float32, max_dist (R,1) int32) for LE channel indices."""
    white = np.stack([_le_dewhiten_header_bits(i) for i in indices])
    aa_on = np.array([[1.0 if i >= 37 else 0.0] for i in indices],
                     dtype=np.float32)
    max_dist = np.array([[2 if i >= 37 else 0] for i in indices],
                        dtype=np.int32)
    return white.astype(np.float32), aa_on, max_dist


def le_table_consts() -> dict:
    """The distance tables as int32 arrays, keyed as the step takes them:
    le_pre_dist (512,), le_aa_dist (4, 256), le_acc_dist and le_dat_dist
    (2, 256) (header byte 0, byte 1)."""
    return dict(le_pre_dist=LE_PREAMBLE_DISTANCE.astype(np.int32),
                le_aa_dist=AA_DISTANCE.astype(np.int32),
                le_acc_dist=np.stack(ACCESS_HEADER_DISTANCE).astype(np.int32),
                le_dat_dist=np.stack(DATA_HEADER_DISTANCE).astype(np.int32))


def le_detect_batch(bits, white, aa_on, max_dist, *, le_pre_dist,
                    le_aa_dist, le_acc_dist, le_dat_dist):
    """All LE rows at once.

    bits: (R, T) 0/1 symbols (any real or integer dtype); white (R, 16),
    aa_on (R, 1), max_dist (R, 1) from le_row_consts; the tables from
    le_table_consts, on the same device.  Returns (hits bool, dist int32),
    each (R, T-55)."""
    R, T = bits.shape
    n = T - 56 + 1
    b = bits.to(torch.int64)
    w = white.to(torch.int64)

    def field(start, nbits, dewhiten_from=None):
        v = torch.zeros((R, n), dtype=torch.int64, device=b.device)
        for j in range(nbits):
            bj = b[:, start + j: start + j + n]
            if dewhiten_from is not None:
                bj = bj ^ w[:, dewhiten_from + j, None]
            v = v + (bj << j)
        return v

    pre_d = le_pre_dist[field(0, 9)]
    hdr_l = field(40, 8, dewhiten_from=0)
    hdr_m = field(48, 8, dewhiten_from=8)
    acc_d = le_acc_dist[0][hdr_l] + le_acc_dist[1][hdr_m]
    dat_d = le_dat_dist[0][hdr_l] + le_dat_dist[1][hdr_m]
    adv = aa_on > 0.5
    hdr_d = torch.where(adv, acc_d, dat_d)
    aa_d = torch.zeros_like(pre_d)
    for k in range(4):
        aa_d = aa_d + le_aa_dist[k][field(8 + 8 * k, 8)]
    dist = pre_d + hdr_d + torch.where(adv, aa_d, 0)
    return dist <= max_dist, dist
