"""The plain reference front end: one block of (2, N) float32 planes ->
the slot SNR plane, the classic hits and the LE hits, as the receiver's
fused chain defines them, computed with the plain PyTorch of plain.py.

Written for the benchmark from the receiver's published behaviour (the
bank, the squelch, the hit rules of gr-bluetooth's multi_block): it
builds its own bank, tables and constants from the configuration, and
takes nothing that the program under test has made.  `control=True` is
the control of the check: the channelizer's DFT in TF32 (both operands
rounded to TF32, float32 sums: a tensor core's TF32 product), one
precision below the float32 the configuration states, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import plain
from ..traffic.air.constants import (SYMBOLS_AC_SHORT, SYMBOLS_LE_PREAMBLE_AA,
                                     SYMBOLS_PER_SLOT)
from ..traffic.air.le_tables import freq2index

__all__ = ["RefFrontEnd", "tf32"]


def tf32(x):
    """float32 values rounded to TF32 (10 mantissa bits, to nearest,
    ties to even), as a tensor core takes a TF32 operand."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class RefFrontEnd:
    """The reference for one configuration (even-integer Msps rates, the
    polyphase bank).  step() runs one block; hits() turns its outputs
    into the hit rows the comparison reads."""

    def __init__(self, sample_rate: float, center_freq: float, *,
                 squelch_db: float, block_slots: int, max_ac_errors: int,
                 enable_le: bool, device):
        self.device = torch.device(device)
        b = plain.make_pfb_bank(sample_rate, center_freq)
        self.bank = b
        self.block_slots = block_slots
        self.samples_per_slot = SYMBOLS_PER_SLOT * b.sps
        self.step_samples = block_slots * self.samples_per_slot
        self.overlap_samples = (plain.LOOKAHEAD_SLOTS * self.samples_per_slot
                                + (b.ntaps - 1) + 4 * b.decim)
        self.block_samples = self.step_samples + self.overlap_samples
        self.n_sym = (block_slots + plain.LOOKAHEAD_SLOTS) * SYMBOLS_PER_SLOT
        self.delay_sym = int(round(((b.ntaps - 1) / 2 + b.decim) / b.sps))
        self.max_hits = max(128, 2 * block_slots + 64)
        self.le_rows = [(i, ch, freq2index(2402e6 + ch * 1e6))
                        for i, ch in enumerate(b.channels)
                        if freq2index(2402e6 + ch * 1e6) >= 0]
        n_data_rows = sum(1 for r in self.le_rows if r[2] < 37) or 1
        fp_budget = n_data_rows * self.n_sym / 512.0
        self.max_le_hits = max(64, 4 * block_slots,
                               min(int(4 * fp_budget) + 64, 512))
        self.enable_le = bool(enable_le and self.le_rows)
        self.squelch = float(squelch_db)
        self.max_ac_errors = max_ac_errors
        sc = plain.make_stream_snr_consts(b)
        self.slot_ch, self.kappa = sc.slot_ch, sc.kappa
        n_off = self.n_sym - 72 + 1
        s0, ma = plain._word_slot_consts(-(-n_off // 32), self.delay_sym)
        c = dict(h0=b.h0, h1=b.h1, dft_c=b.dft_c, dft_s=b.dft_s,
                 bin_odd=b.bin_odd, probe_re=sc.taps_re, probe_im=sc.taps_im,
                 ac_masks=plain.ac_masks(), word_s0=s0.astype(np.int64),
                 word_mask_a=ma, **plain.ac_product_consts())
        if self.enable_le:
            c["le_rows"] = np.array([r[0] for r in self.le_rows])
            le = plain.le_step_consts(
                *plain.le_row_consts([r[2] for r in self.le_rows]),
                n_sym=self.n_sym, delay_sym=self.delay_sym)
            le["le_word_s0"] = le["le_word_s0"].astype(np.int64)
            c.update(le)
        self.c = {k: torch.from_numpy(np.array(v, copy=True)).to(self.device)
                  for k, v in c.items()}

    def step(self, x, control: bool = False):
        """(2, block_samples) float32 planes -> (snr_db (S, C), classic
        table (max_hits, 4), n_hits, LE table (max_le_hits, 3), n_le),
        as host arrays; the LE pair is None with LE off.  `control`
        takes the DFT in TF32."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        fir = plain.branch_fir
        if control:
            plain.branch_fir = lambda *a: tf32(fir(*a))
        try:
            with torch.no_grad():
                out = self._step(x, control)
        finally:
            plain.branch_fir = fir
        return tuple(None if o is None else o.cpu().numpy() for o in out)

    def _step(self, x, low: bool = False):
        c, b = self.c, self.bank
        dft_c, dft_s = ((tf32(c["dft_c"]), tf32(c["dft_s"])) if low else
                        (c["dft_c"], c["dft_s"]))
        n, n_data, S, n_k, n_frames = plain.step_geometry(
            x.shape[1], c["h0"].shape[0], b.decim, self.n_sym, self.slot_ch,
            c["probe_re"].shape[0])
        yr, yi, oe = plain.pfb_snr_plain(x, c["h0"], c["h1"], dft_c, dft_s,
                                         c["bin_odd"], n_frames)
        words, pe = plain.demod_pack_plain(yr, yi, b.demod_gain, self.n_sym,
                                           c["probe_re"], c["probe_im"], n_k,
                                           n_data)
        del yr, yi
        snr_db = plain.assemble_slot_snr(oe, pe, S=S, slot_ch=self.slot_ch,
                                         kappa=self.kappa, tile=plain.TF)
        words = words[:-1]                              # the probe row
        hitw, _, _ = plain.detect_words_plain(words, self.n_sym - 72 + 1,
                                              self.max_ac_errors,
                                              c["ac_masks"])
        n_hits, tab, _ = plain.hit_table_plain(
            hitw, words, None, snr_db, word_s0=c["word_s0"],
            word_mask_a=c["word_mask_a"], squelch=self.squelch,
            max_hits=self.max_hits,
            ac=dict(ac_a68t=c["ac_a68t"], ac_c68=c["ac_c68"]))
        if not self.enable_le:
            return snr_db, tab, n_hits, None, None
        rows = c["le_rows"]
        lew, _ = plain.le_detect_plain(
            words, rows, self.n_sym, c["le_white_word"], c["le_aa_on"],
            c["le_max_dist"], with_dist=False,
            **{k: c[k] for k in plain.LE_TABLES})
        le = dict(le_white_word=c["le_white_word"], le_aa_on=c["le_aa_on"],
                  **{k: c[k] for k in plain.LE_TABLES})
        n_le, le_tab, _ = plain.hit_table_plain(
            lew, words, rows, snr_db, word_s0=c["le_word_s0"],
            word_mask_a=c["le_word_mask_a"], squelch=self.squelch,
            max_hits=self.max_le_hits, le=le)
        return snr_db, tab, n_hits, le_tab, n_le

    def hits(self, tab, n_hits, le_tab=None, n_le=None):
        """A block's tables -> (classic rows, LE rows) as the receiver
        reports them: offsets past the block's slots left to the next
        block, hits inside an earlier access code of their row skipped,
        ordered by offset; classic rows (channel row, offset, slot, LAP,
        errors), LE rows (row, offset, slot, distance)."""
        limit = self.block_slots * SYMBOLS_PER_SLOT
        out = []
        for table, n, span, ncol in ((tab, n_hits, SYMBOLS_AC_SHORT, 4),
                                     (le_tab, n_le, SYMBOLS_LE_PREAMBLE_AA,
                                      3)):
            rows = []
            if table is not None:
                table = np.asarray(table)
                k = min(int(n), table.shape[0])
                last: dict = {}
                for i in np.argsort(table[:k, 1], kind="stable"):
                    r = [int(v) for v in table[i, :ncol]]
                    c, t = r[0], r[1]
                    if t >= limit or t < last.get(c, 0):
                        continue
                    last[c] = t + span
                    slot = (t + self.delay_sym) // SYMBOLS_PER_SLOT
                    rows.append((c, t, slot, *r[2:]))
            out.append(rows)
        return out[0], out[1]
