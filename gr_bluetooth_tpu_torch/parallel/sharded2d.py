"""2-D sharding: time chunks x channel groups over a grid of devices.

The port of gr_bluetooth_tpu/parallel/sharded2d.py.  `ShardedFrontEnd`
(sharded.py) scales throughput by splitting a capture along TIME; each
shard still computes all 79 channels, so one superblock's latency is
fixed.  This module adds the CHANNEL axis: a (time, chan) grid of
devices where each shard computes its time chunk for only a contiguous
GROUP of channels, so per-superblock latency shrinks with the chan axis
while the time axis keeps adding throughput.

Work split inside the fused step (_fused_step: pfb_snr, demod_pack,
detect_words and the torch tail):

  * The wideband input is copied to every shard of its time row (each
    chunk's samples contain every channel) and the polyphase branch FIR
    is recomputed per channel group.
  * Everything after the FIR — the DFT (its bin columns are per-group
    constants), GFSK demod, timing recovery, slicing, SNR probe, AC/LE
    detection, hit extraction, window gather — runs on the group's
    channels only: pfb_snr and demod_pack at Cg + 1 columns, detect_words
    at Cg rows.

Channel groups stay CONTIGUOUS slices of the bank so the SNR noise probe
keeps its structure (channel c's +790 kHz probe is read from stream row
c+1 — ops/snr.py): group g's streams are bank rows [s_g, s_g+Cg], the
last column being the probe for the group's top channel.  79 is prime, so
equal-size groups must overlap: the last group starts at C-Cg and its
first `G*Cg - C` channels duplicate the previous group's tail; the host
drops hits from the duplicated range, so assembled results are exactly
the unsharded stream's.

Communication: the time axis's halo, as in sharded.py (each channel
group's shards form one time column); the chan axis is communication-
free — per-group hit tables are concatenated on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.frontend import BlockResult, FrontEnd, consts_to_device
from ..ops import detect
from .sharded import Column, as_devices, host_consts, superblocks, to_host

__all__ = ["Sharded2DFrontEnd"]


class Sharded2DFrontEnd:
    """Run a FrontEnd's fused step over a (time, chan) grid of devices,
    given as a nested list: devices[t][g] holds time chunk t of channel
    group g.  A device may appear several times, as in [[cuda:0] * 2] * 2;
    every entry is one shard."""

    def __init__(self, fe: FrontEnd, devices):
        if not fe.is_pfb:
            raise ValueError("channel sharding requires the polyphase bank "
                             "(even samples/symbol rates)")
        if fe.step_samples < fe.overlap_samples:
            raise ValueError("chunk must be at least as long as the halo; "
                             "increase block_slots")
        grid = [as_devices(row) for row in devices]
        if not grid or len({len(row) for row in grid}) != 1:
            raise ValueError("devices must be a non-empty (time, chan) grid "
                             "with rows of equal length")
        as_devices([d for row in grid for d in row])   # one device type
        self.fe = fe
        self.grid = grid
        self.n_time = Tn = len(grid)
        self.n_chan = G = len(grid[0])
        bank = fe.bank
        C = bank.n_channels
        if G > C:
            raise ValueError(f"chan axis ({G}) larger than channel count "
                             f"({C})")
        Cg = -(-C // G)
        # contiguous, possibly overlapping groups: group g covers bank
        # channels [starts[g], starts[g]+Cg); locals < valid_start[g]
        # duplicate the previous group and are dropped at assembly
        starts = [min(g * Cg, C - Cg) for g in range(G)]
        valid_start = [0] + [max(0, starts[g - 1] + Cg - starts[g])
                             for g in range(1, G)]
        self.group_size = Cg
        self.starts = starts
        self.valid_start = valid_start

        # per-group DFT columns: channel cols [s, s+Cg) plus the probe col
        # s+Cg (the next channel up, or the bank's own probe row at the top)
        host = host_consts(fe)
        group_consts = [dict(host,
                             dft_c=np.ascontiguousarray(
                                 host["dft_c"][:, s:s + Cg + 1]),
                             dft_s=np.ascontiguousarray(
                                 host["dft_s"][:, s:s + Cg + 1]),
                             bin_odd=host["bin_odd"][s:s + Cg + 1].copy())
                        for s in starts]

        self.with_le = bool(fe.enable_le and fe.le_rows)
        self.le_maps: list[list[int]] = [[] for _ in range(G)]
        if self.with_le:
            for j, (row, _ch, _li) in enumerate(fe.le_rows):
                for g in range(G):
                    if starts[g] + valid_start[g] <= row < starts[g] + Cg:
                        self.le_maps[g].append(j)
            lmax = max(len(m) for m in self.le_maps)
            for g, m in enumerate(self.le_maps):
                rows = np.zeros(lmax, np.int64)
                white = np.zeros((lmax, 16), np.float32)
                aa = np.zeros((lmax, 1), np.float32)
                # max_dist = -1 on pad rows: distance >= 0, so pads never
                # hit
                dist = np.full((lmax, 1), -1, np.int32)
                if m:
                    k = len(m)
                    w, a, d = detect.le_row_consts(
                        [fe.le_rows[j][2] for j in m])
                    rows[:k] = [fe.le_rows[j][0] - starts[g] for j in m]
                    white[:k], aa[:k], dist[:k] = w, a, d
                group_consts[g].update(
                    le_rows=rows, le_white_word=detect.le_white_words(white),
                    le_aa_on=aa, le_max_dist=dist)

        on_dev: dict = {}
        self.columns = []
        for g in range(G):
            col_devs = [grid[t][g] for t in range(Tn)]
            for d in col_devs:
                if (g, d) not in on_dev:
                    on_dev[g, d] = consts_to_device(group_consts[g], d)
            self.columns.append(Column(fe, col_devs,
                                       [on_dev[g, d] for d in col_devs]))
        self.chunk_samples = fe.step_samples
        self.overlap_samples = fe.overlap_samples
        self.total_samples = fe.step_samples * Tn    # one superblock
        self.superblock_slots = fe.block_slots * Tn

    def device_put(self, x: np.ndarray):
        """Place (2, n_time*step) float32 planes on the grid: chunk t on
        every shard of time row t."""
        x = np.asarray(x, np.float32)
        return [col.place(x) for col in self.columns]

    def step(self, placed, next_head):
        """One superblock step; per-(time, chan)-shard outputs on
        devices[0][0]: (T, G, S, Cg), (T, G, 1), (T, G, K, 4),
        (T, G, K, W8) [+ LE]."""
        outs = []
        for col, (blocks, events) in zip(self.columns, placed):
            col.halos(blocks, events)
            col.set_halo(self.n_time - 1, blocks, next_head)
            outs.append(col.launch(blocks))
        dev0 = self.grid[0][0]
        return tuple(torch.stack([o[j].to(dev0) for o in outs], 1)
                     for j in range(len(outs[0])))

    # ------------------------------------------------------------- host

    def _merge_tab(self, n_hits, tab, windows, d, first_col_min):
        """Concatenate one time shard's per-group hit tables into a single
        channel-major table with GLOBAL channel indices, dropping rows from
        each group's duplicated-coverage prefix.

        Vectorized (one mask + one fancy-index pass); np.nonzero's
        row-major order preserves the (group, row) order."""
        K = tab.shape[2]
        raw = n_hits[d, :, 0].astype(np.int64)            # (G,)
        kcl = np.minimum(raw, K)
        extra = int((raw - kcl).sum())
        idx = np.arange(K)[None, :]
        tb = tab[d]                                       # (G, K, 4)
        keep = (idx < kcl[:, None]) & \
            (tb[:, :, 0] >= np.asarray(first_col_min)[:, None])
        g_idx, i_idx = np.nonzero(keep)
        tab_m = tb[g_idx, i_idx].copy()
        if tab_m.size:
            tab_m[:, 0] += np.asarray(self.starts)[g_idx]
        win_m = windows[d][g_idx, i_idx]
        return len(tab_m) + extra, tab_m, win_m

    def _merge_le(self, n_le, le_tab, le_win, d):
        K = le_tab.shape[2]
        raw = n_le[d, :, 0].astype(np.int64)
        kcl = np.minimum(raw, K)
        extra = int((raw - kcl).sum())
        idx = np.arange(K)[None, :]
        keep = idx < kcl[:, None]
        g_idx, i_idx = np.nonzero(keep)
        tab_m = le_tab[d][g_idx, i_idx].copy()
        if tab_m.size:
            # per-group local LE row -> global LE row, via a padded map
            mlen = max(len(m) for m in self.le_maps)
            lm = np.zeros((self.n_chan, mlen), np.int64)
            for g, m in enumerate(self.le_maps):
                lm[g, :len(m)] = m
            tab_m[:, 0] = lm[g_idx, np.clip(tab_m[:, 0], 0, mlen - 1)]
        win_m = le_win[d][g_idx, i_idx]
        return len(tab_m) + extra, tab_m, win_m

    def _assemble(self, out, slot_base: int) -> list[BlockResult]:
        host = to_host(out)
        if self.with_le:
            snr_db, n_hits, tab, windows, n_le, le_tab, le_win = host
        else:
            snr_db, n_hits, tab, windows = host
            n_le = le_tab = le_win = None
        Cg = self.group_size
        vs = self.valid_start
        results = []
        for d in range(self.n_time):
            snr_full = np.concatenate(
                [snr_db[d, g][:, vs[g]:Cg] for g in range(self.n_chan)],
                axis=1)
            n_m, tab_m, win_m = self._merge_tab(n_hits, tab, windows, d, vs)
            if self.with_le:
                nle_m, letab_m, lewin_m = self._merge_le(n_le, le_tab,
                                                         le_win, d)
            else:
                nle_m = letab_m = lewin_m = None
            results.append(self.fe.assemble_block(
                snr_full, n_m, tab_m, win_m, nle_m, letab_m, lewin_m,
                slot_base=slot_base + d * self.fe.block_slots))
        return results

    def stream(self, samples: np.ndarray, start_clkn: int = 0):
        """Iterate merged BlockResults (one per time shard per superblock)
        over a long capture — identical hits to FrontEnd.stream."""
        samples = self.fe._host_planes(samples)
        slot_base = start_clkn
        for chunk, head in superblocks(samples, self.total_samples,
                                       self.overlap_samples):
            out = self.step(self.device_put(chunk), head)
            yield from self._assemble(out, slot_base)
            slot_base += self.superblock_slots

    def process(self, samples: np.ndarray, start_clkn: int = 0):
        return list(self.stream(samples, start_clkn))
