"""LE access-address detection.

The port of the LE half of gr_bluetooth_tpu/ops/detect.py
(_le_dewhiten_header_bits, le_row_consts, _le_detect_batch_impl): for
every offset of every LE row, the Hamming distances of the 9-bit
preamble (+ first AA bit), of the dewhitened 16-bit header and, on the
advertising rows, of the access address to their valid sets, looked up
in the generated tables (core/le_tables.py; the tables the reference
hard-codes, lib/packet_impl.cc:1316-1444).  The reference slides one
offset at a time (sniff_aa, lib/packet_impl.cc:1452-1527).

The JAX package computes it outside any Pallas kernel, as plain jnp
over dense rows.  The port has two forms:

  le_detect_batch  the dense form over (R, T) symbol rows, in torch:
                   field values built from shifted bit slices, table
                   lookups with int64 indices;
  le_detect        the step's form over the packed word plane: a CUDA
                   kernel (csrc/le_detect.cu, a port kernel with no TPU
                   counterpart) for CUDA tensors; for CPU tensors its
                   plain version, le_detect_plain (the rows unpacked,
                   le_detect_batch, the hits packed).  The step takes the
                   hit plane alone (with_dist=False); the dense distances
                   are for the checks.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import whitening
from ..core.le_tables import (AA_DISTANCE, ACCESS_HEADER_DISTANCE,
                              DATA_HEADER_DISTANCE, LE_PREAMBLE_DISTANCE)
from ..utils import cuda_build
from .detect_kernel import pack_bits_words, unpack_words

__all__ = ["le_detect", "le_detect_batch", "le_detect_plain",
           "le_row_consts", "le_table_consts", "le_white_words",
           "LE_SPAN"]

LE_SPAN = 56       # symbols an offset reads: preamble, AA, header


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


def le_white_words(white) -> np.ndarray:
    """(R, 16) 0/1 whitening bits (le_row_consts) -> (R,) int32, bit j =
    white[:, j]: le_detect's per-row whitening word."""
    w = np.asarray(white).astype(np.int64) & 1
    return (w << np.arange(16)).sum(1).astype(np.int32)


def le_table_consts() -> dict:
    """The distance tables as uint8 arrays (their type at the source),
    keyed as the step takes them: le_pre_dist (512,), le_aa_dist
    (4, 256), le_acc_dist and le_dat_dist (2, 256) (header byte 0,
    byte 1)."""
    return dict(le_pre_dist=LE_PREAMBLE_DISTANCE.astype(np.uint8),
                le_aa_dist=AA_DISTANCE.astype(np.uint8),
                le_acc_dist=np.stack(ACCESS_HEADER_DISTANCE).astype(np.uint8),
                le_dat_dist=np.stack(DATA_HEADER_DISTANCE).astype(np.uint8))


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
    le_pre_dist, le_aa_dist, le_acc_dist, le_dat_dist = (
        t.to(torch.int32) for t in (le_pre_dist, le_aa_dist, le_acc_dist,
                                    le_dat_dist))

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


def _check(words, rows, white_word, aa_on, max_dist, tables):
    if words.dtype != torch.int32 or words.ndim != 2:
        raise TypeError("le_detect: words must be (C, W) int32")
    R = rows.shape[0]
    want = dict(rows=(rows, torch.int64, (R,)),
                white_word=(white_word, torch.int32, (R,)),
                aa_on=(aa_on, torch.float32, (R, 1)),
                max_dist=(max_dist, torch.int32, (R, 1)),
                le_pre_dist=(tables["le_pre_dist"], torch.uint8, (512,)),
                le_aa_dist=(tables["le_aa_dist"], torch.uint8, (4, 256)),
                le_acc_dist=(tables["le_acc_dist"], torch.uint8, (2, 256)),
                le_dat_dist=(tables["le_dat_dist"], torch.uint8, (2, 256)))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or \
                t.device != words.device:
            raise ValueError(f"le_detect: {name} must be {dtype} of shape "
                             f"{shape} on the words' device")


def le_detect_plain(words, rows, n_sym: int, white_word, aa_on, max_dist,
                    *, with_dist: bool = True, le_pre_dist, le_aa_dist,
                    le_acc_dist, le_dat_dist):
    """Plain PyTorch version of le_detect (same arguments and results):
    the rows unpacked to dense symbols, le_detect_batch, the hits
    packed."""
    bits = unpack_words(words[rows], n_sym)
    white = (white_word[:, None] >>
             torch.arange(16, device=words.device)) & 1
    hits, dist = le_detect_batch(
        bits, white, aa_on, max_dist, le_pre_dist=le_pre_dist,
        le_aa_dist=le_aa_dist, le_acc_dist=le_acc_dist,
        le_dat_dist=le_dat_dist)
    return pack_bits_words(hits), (dist if with_dist else None)


def _launcher():
    fn = cuda_build.load("le_detect").le_detect_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, I, P, P, P, P, P, P, P, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def le_detect(words, rows, n_sym: int, white_word, aa_on, max_dist, *,
              with_dist: bool = True, **tables):
    """LE detection on the packed word plane.

    words (C, W) int32 (symbol t at bit t % 32 of word t // 32, at least
    n_sym symbols), rows (R,) int64 word rows of the LE channels,
    white_word (R,) int32 (le_white_words), aa_on (R, 1) float32 and
    max_dist (R, 1) int32 (le_row_consts), and the four tables of
    le_table_consts (le_pre_dist, le_aa_dist, le_acc_dist, le_dat_dist),
    all on the words' device -> (hitw, dist): the packed hit plane
    (R, ceil(n_le / 32)) int32, bit t of word w = offset 32w + t, zero
    past n_le = n_sym - 55 offsets; and dist (R, n_le) int32, as
    le_detect_batch on the unpacked rows, or None with with_dist=False
    (the step's form: the kernel then writes the hit plane alone).  A
    CPU tensor runs the plain version; a CUDA tensor launches
    csrc/le_detect.cu, counted in le_detect.launches (the step's form)
    or le_detect.dist_launches (with the distances)."""
    _check(words, rows, white_word, aa_on, max_dist, tables)
    n_le = n_sym - LE_SPAN + 1
    if n_le <= 0 or n_sym > 32 * words.shape[1]:
        raise ValueError(f"le_detect: {n_sym} symbols do not fit the words "
                         f"or hold no LE offset")
    if words.device.type == "cpu":
        return le_detect_plain(words, rows, n_sym, white_word, aa_on,
                               max_dist, with_dist=with_dist, **tables)
    if words.device.type != "cuda":
        raise ValueError(f"le_detect: unsupported device {words.device}")
    R, W = rows.shape[0], words.shape[1]
    w_le = -(-n_le // 32)
    words = words.contiguous()
    hitw = torch.empty((R, w_le), dtype=torch.int32, device=words.device)
    dist = torch.empty((R, n_le), dtype=torch.int32, device=words.device) \
        if with_dist else None
    t = [tables[k].contiguous() for k in ("le_pre_dist", "le_aa_dist",
                                          "le_acc_dist", "le_dat_dist")]
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = _launcher()(words.data_ptr(), W, rows.contiguous().data_ptr(),
                         R, white_word.contiguous().data_ptr(),
                         aa_on.contiguous().data_ptr(),
                         max_dist.contiguous().data_ptr(),
                         *(x.data_ptr() for x in t), n_le, w_le,
                         hitw.data_ptr(),
                         None if dist is None else dist.data_ptr(), stream)
    cuda_build.check(rc, "le_detect")
    if with_dist:
        le_detect.dist_launches += 1
    else:
        le_detect.launches += 1
    return hitw, dist


le_detect.launches = 0
le_detect.dist_launches = 0
