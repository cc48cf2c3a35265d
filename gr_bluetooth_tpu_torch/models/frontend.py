"""Streaming wideband front end: blocks of IQ -> compact hit tables.

The port of gr_bluetooth_tpu/models/frontend.py, at every rate of 2 Msps
or more that the reference accepts.  Long IQ blocks flow through the
device pipeline once, with a 5-slot lookahead overlap so packets that
start near the end of a block are fully decodable; the dense per-offset
detection planes are reduced on the device to a fixed-size hit table
(channel, offset, LAP, errors) plus per-hit symbol windows, so a block's
host traffic is a few hundred KB.

At even-integer rates two chains compute one block's step, as in the
JAX package's _device_step, which takes the first for flat (2, N) planes
and the second for the staged layout that stream() builds:

  flat (_device_step: device_step, process_block, stream_sync)
    deinterleave   (2, N) -> (2, D, n_x) branch rows [CUDA, ops/pfb]
    pfb_channelize polyphase FIR + DFT + rotator     [CUDA, ops/pfb_kernel]
    stream SNR     slot on/off energies from y       [torch, ops/snr]
    demod          discriminator, 16-phase timing, slicer -> dense bits
                   -> packed words                   [torch, ops/demod]
  fused (_fused_step: stream, through io/ingest.py)
    pfb_snr        channelize and per-tile on-energies [CUDA, ops/pfb_kernel]
    demod_pack     discriminator, timing, slicer, word pack, probe
                   energies                          [CUDA, ops/demod_kernel]
    slot SNR       segment sums of the partials      [torch, ops/snr]

Odd-integer rates have no polyphase bank and no fused chain: their one
step (_conv_step: device_step, process_block, stream_sync and stream)
is the strided conv bank, as the JAX package's _device_step with is_pfb
false:

  conv           strided conv bank + exact rotator [torch conv1d (cuDNN),
                 FP32, ops/channelizer]
  slot SNR       one FFT per slot, two FP32 matmuls against |H|^2
                 columns                           [torch, ops/snr]
  demod          discriminator, 16-phase timing at ch_sps = sps/decim,
                 slicer -> dense bits -> packed words [torch, ops/demod]

Off-grid rates (2.5, 7.68 Msps, ...) are resampled on the host to the
nearest even integer Msps (ops/resample.py) and then run the polyphase
bank at that internal rate, restricted to the true band's channels;
stream() takes the fused chain, stream_sync() the flat one.

All steps end in the same packed tail (_packed_tail):

    detect_words   packed access-code detection      [CUDA, ops/detect_kernel]
    le_detect      (enable_le) the LE detector on the packed words, hit
                   plane only                        [CUDA, ops/detect]
    hit_table      squelch AND on the word plane, first-k hit extraction,
                   bit-aligned window gather, LAP and error count from
                   each window (the 68 bits against the access code the
                   LAP predicts); with LE on, in the same launch
                   (hit_tables), its LE form over le_detect's plane:
                   squelch, extraction, LE windows, each hit's distance
                   from its window; one thread-block cluster per tail
                                                     [CUDA, ops/hit_table]

Nothing on the step reads a value back to the host, and its shapes are
static, so on a CUDA device each step is captured once as a CUDA graph
and replayed per block (utils/graph.py, the counterpart of the JAX
package's jit): compiled_step(chain) for the flat (or conv-bank) and the
fused chain, cached per front end as the JAX FrontEnd keeps _jit_step.
process_block (hence stream_sync) replays the flat or conv-bank graph,
stream() the ingest's graph (io/ingest.py); device_step and fused_step
stay the eager bodies.  Hits within the first B slots are reported; the
stream advances B slots.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (DEFAULT_SNR_DB, SYMBOLS_AC_SHORT,
                         SYMBOLS_LE_PREAMBLE_AA, SYMBOLS_PER_SLOT)
from ..core.le_tables import freq2index
from ..ops import (channelizer, demod, demod_kernel, detect, detect_kernel,
                   hit_table, pfb, pfb_kernel, resample, snr)
# the tail's plain pieces, importable here under their names
from ..ops.hit_table import (LE_WIN_SYMBOLS, WIN_SYMBOLS,  # noqa: F401
                             _extract_hits_packed, _gather_windows,
                             _hit_rows, _squelch_gate_words)
from ..utils.device import resolve_device
from ..utils.graph import StepCache
from ..utils.log import get_logger

__all__ = ["FrontEnd", "Hit", "LeHit", "BlockResult"]

log = get_logger("frontend")

LOOKAHEAD_SLOTS = 5      # max packet length
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Hit:
    """One classic access-code candidate."""
    channel: int          # BR channel number
    chan_idx: int         # row in the channel bank
    clkn: int             # native slot clock at packet start
    sym_offset: int       # raw symbol offset within the block's bit stream
    lap: int
    errors: int
    snr_db: float
    win_row: int          # row in BlockResult.windows


@dataclass(frozen=True)
class LeHit:
    """One LE access-address candidate."""
    channel: int          # BR channel grid number (freq = 2402 + ch MHz)
    freq: float
    index: int            # LE channel index 0..39
    clkn: int
    sym_offset: int
    distance: int
    snr_db: float
    win_row: int          # row in BlockResult.le_windows


@dataclass
class BlockResult:
    slot_base: int              # clkn of the block's first slot
    snr_db: np.ndarray          # (S, C) per-slot SNR
    hits: list                  # list[Hit], ordered by offset
    le_hits: list               # list[LeHit], ordered by offset
    windows: np.ndarray         # (K, WIN_SYMBOLS // 32 + 1) int32 windows
    le_windows: np.ndarray      # (K_le, LE_WIN_SYMBOLS // 32 + 1) int32
    n_slots: int                # slots advanced by this block


class FrontEnd:
    def __init__(self, sample_rate: float, center_freq: float,
                 squelch_threshold: float = DEFAULT_SNR_DB,
                 block_slots: int = 16, max_ac_errors: int = 6,
                 use_squelch: bool = True, enable_le: bool = False,
                 max_hits: int | None = None,
                 max_le_hits: int | None = None, device=None):
        self.device = resolve_device(device)
        # polyphase DFT bank for even samples/symbol, the strided conv
        # bank for odd integer rates; off-grid rates (the reference
        # accepts any rate >= 2 Msps, lib/multi_block.cc:82) resample to
        # the nearest even integer Msps first and run the polyphase bank
        # restricted to the TRUE band's channels
        self.input_rate = sample_rate
        self.resampler = None
        self.weights = None
        spsf = sample_rate / 1e6
        if abs(spsf - round(spsf)) < 1e-9 and round(spsf) >= 2:
            if round(spsf) % 2 == 0:
                b = pfb.make_pfb_bank(sample_rate, center_freq)
            else:
                b = channelizer.make_bank(sample_rate, center_freq)
        else:
            fs_int = resample.pick_internal_rate(sample_rate)
            self.resampler = resample.make_resampler(sample_rate, fs_int)
            b = pfb.make_pfb_bank(
                fs_int, center_freq,
                channels=channelizer.select_channels(sample_rate,
                                                     center_freq))
        self.bank = b
        self.is_pfb = isinstance(b, pfb.PfbBank)
        self.block_slots = block_slots
        self.samples_per_slot = SYMBOLS_PER_SLOT * b.sps
        # wideband samples consumed per block step
        self.step_samples = self.block_slots * self.samples_per_slot
        # extra samples needed: lookahead slots + filter/demod history
        self.overlap_samples = (LOOKAHEAD_SLOTS * self.samples_per_slot +
                                (b.ntaps - 1) + 4 * b.decim)
        self.block_samples = self.step_samples + self.overlap_samples
        self.n_sym = (self.block_slots + LOOKAHEAD_SLOTS) * SYMBOLS_PER_SLOT
        # the bit stream LEADS the input by the filter group delay: symbol
        # t sits at wideband sample ~ t*sps + (ntaps-1)/2 + decim; used when
        # attributing a detection offset to a slot / clkn
        self.delay_sym = int(round(((b.ntaps - 1) / 2 + b.decim) / b.sps))
        # 2 hits/slot + margin; overflow is detected and logged
        self.max_hits = max_hits or max(128, 2 * block_slots + 64)
        # LE rows: bank channels on the LE 2 MHz grid, (row, BR channel,
        # LE index)
        self.le_rows = [(i, ch, freq2index(2402e6 + ch * 1e6))
                        for i, ch in enumerate(b.channels)
                        if freq2index(2402e6 + ch * 1e6) >= 0]
        # LE hit-table capacity: data-row detection is exact-match, which
        # random symbols pass at ~2^-9 per offset, but only busy rows and
        # slots survive the squelch; capped at 512, overflow is counted
        # and logged (assemble_block)
        n_data_rows = sum(1 for r in self.le_rows if r[2] < 37) or 1
        fp_budget = n_data_rows * self.n_sym / 512.0
        self.max_le_hits = max_le_hits or max(
            64, 4 * block_slots, min(int(4 * fp_budget) + 64, 512))
        self.enable_le = bool(enable_le and self.le_rows)

        n_off = self.n_sym - 72 + 1
        self.statics = dict(
            decim=b.decim, n_sym=self.n_sym, demod_gain=b.demod_gain,
            max_ac_errors=max_ac_errors, delay_sym=self.delay_sym,
            squelch=(float(squelch_threshold) if use_squelch else None),
            max_hits=self.max_hits, max_le_hits=self.max_le_hits)
        s0, ma = _word_slot_consts(-(-n_off // 32), self.delay_sym)
        consts = dict(ac_masks=detect_kernel.ac_masks(), word_s0=s0,
                      word_mask_a=ma, **ac_product_consts())
        if self.is_pfb:
            sc = snr.make_stream_snr_consts(b)
            Q = b.h0.shape[0]
            self.statics.update(
                n_y=self.block_samples // b.decim - 2 * Q,  # true frames
                slot_ch=sc.slot_ch, kappa=sc.kappa)
            consts.update(h0=b.h0, h1=b.h1, dft_c=b.dft_c, dft_s=b.dft_s,
                          bin_odd=b.bin_odd, probe_re=sc.taps_re,
                          probe_im=sc.taps_im)
        else:
            self.weights = w = snr.make_snr_weights(b)
            self.statics.update(sps=b.sps, ch_sps=b.ch_sps,
                                slot_len=w.slot_len)
            consts.update(kernel=b.kernel, rot_q=b.rot_q, on_w=w.on_w,
                          off_w=w.off_w)
        if self.enable_le:
            consts.update(le_rows=np.array([r[0] for r in self.le_rows]),
                          **le_step_consts(
                              *detect.le_row_consts(
                                  [r[2] for r in self.le_rows]),
                              n_sym=self.n_sym, delay_sym=self.delay_sym))
        self.consts = consts_to_device(consts, self.device)
        self.graphs = StepCache(self.device)   # the compiled steps
        self._ingests: dict = {}        # wire -> PipelinedIngest

    # ------------------------------------------------------------ device

    def to_planes(self, x) -> torch.Tensor:
        """Host or device samples -> (2, N) float32 planes on the device:
        complex (N,) arrays are split, planes pass through."""
        return _planes(x).to(self.device)

    def device_step(self, x):
        """The flat chain (the conv-bank step at odd rates) on one block
        of wideband IQ at the bank's rate (complex (N,) or (2, N) float32
        planes, host or device).  Returns device tensors (snr_db, n_hits,
        hit_tab, windows, n_le, le_tab, le_windows), the JAX package's
        7-tuple; the LE three are None with LE off."""
        return self._step_fn("flat")(self.to_planes(x), **self.consts,
                                     **self.statics)

    def fused_step(self, x):
        """The fused chain on one block, same input and outputs as
        device_step (stream() runs it); polyphase banks only."""
        return self._step_fn("fused")(self.to_planes(x), **self.consts,
                                      **self.statics)

    def _step_fn(self, chain: str):
        if chain == "fused":
            if not self.is_pfb:
                raise ValueError("the conv bank of odd rates has no fused "
                                 "chain; device_step is its step")
            return _fused_step
        if chain != "flat":
            raise ValueError(f"unknown chain {chain!r}")
        return _device_step if self.is_pfb else _conv_step

    def compiled_step(self, chain: str = "flat", n_samples: int | None =
                      None):
        """The compiled form of one chain's step (a utils.graph
        CompiledStep, built at first use and kept): "flat" is
        device_step's (the conv bank's at odd rates), "fused" fused_step's.
        Call it on (2, n_samples) float32 planes (block_samples by
        default) on any device; it returns the step's 7-tuple as its own
        static tensors, rewritten by the next call of any compiled step of
        this front end.  On a CUDA device each call is one graph replay."""
        fn = self._step_fn(chain)
        n = self.block_samples if n_samples is None else n_samples

        def step(x):
            return fn(x, **self.consts, **self.statics)

        return self.graphs.get((fn, chain), step, [((2, n), torch.float32)])

    # ------------------------------------------------------------ host

    def process_block(self, x, slot_base: int) -> BlockResult:
        from ..utils.metrics import metrics
        with metrics.stage("device_step"):
            x = _planes(x)
            outs = self.compiled_step("flat", x.shape[1])(x)
        with metrics.stage("assemble"):
            # copies: the step's outputs are rewritten by its next call
            res = self.assemble_block(
                *(None if o is None else o.to("cpu", copy=True).numpy()
                  for o in outs), slot_base=slot_base)
        metrics.count("blocks", 1)
        metrics.count("samples_in", self.step_samples)
        metrics.count("classic_hits", len(res.hits))
        metrics.count("le_hits", len(res.le_hits))
        return res

    def assemble_block(self, snr_db, n_hits, hit_tab, windows,
                       n_le=None, le_tab=None, le_windows=None, *,
                       slot_base: int) -> BlockResult:
        """Host-side assembly of one device step's outputs into hits."""
        from ..utils.metrics import metrics
        snr_db = np.asarray(snr_db)
        hit_tab = np.asarray(hit_tab)
        windows = np.asarray(windows)
        raw_hits = int(n_hits)
        n_hits = min(raw_hits, hit_tab.shape[0])
        if raw_hits > hit_tab.shape[0]:
            # fixed-size extraction is channel-major: detections past the
            # table end are LOST, not deferred — surface it so operators
            # can raise max_hits / shrink blocks
            dropped = raw_hits - hit_tab.shape[0]
            metrics.count("hits_dropped", dropped)
            log.warning("classic hit table overflow: %d detections > %d "
                        "rows; %d dropped (raise max_hits or lower "
                        "block_slots)", raw_hits, hit_tab.shape[0], dropped)

        limit = self.block_slots * SYMBOLS_PER_SLOT
        hits: list[Hit] = []
        last_end: dict[int, int] = {}
        order = np.argsort(hit_tab[:n_hits, 1], kind="stable")
        for k in order:
            c, t, lap, err = (int(v) for v in hit_tab[k])
            if t >= limit:
                continue               # next block re-sees offsets >= limit
            if t < last_end.get(c, 0):
                continue               # inside a previous AC (sniff skip rule)
            tc = t + self.delay_sym    # group-delay-corrected position
            slot = tc // SYMBOLS_PER_SLOT
            s_db = float(snr_db[slot, c]) if slot < snr_db.shape[0] else 0.0
            last_end[c] = t + SYMBOLS_AC_SHORT
            hits.append(Hit(channel=self.bank.channels[c], chan_idx=c,
                            clkn=(slot_base + slot) & 0x7FFFFFF,
                            sym_offset=t, lap=lap, errors=err,
                            snr_db=s_db, win_row=int(k)))

        le_hits: list[LeHit] = []
        if n_le is not None:
            le_tab = np.asarray(le_tab)
            le_windows = np.asarray(le_windows)
            raw_le = int(n_le)
            n_le = min(raw_le, le_tab.shape[0])
            if raw_le > le_tab.shape[0]:
                dropped = raw_le - le_tab.shape[0]
                metrics.count("le_hits_dropped", dropped)
                log.warning("LE hit table overflow: %d detections > %d "
                            "rows; %d dropped", raw_le, le_tab.shape[0],
                            dropped)
            le_last: dict[int, int] = {}
            for k in np.argsort(le_tab[:n_le, 1], kind="stable"):
                r, t, dist = (int(v) for v in le_tab[k])
                if t >= limit:
                    continue
                if t < le_last.get(r, 0):
                    continue
                row, ch, index = self.le_rows[r]
                slot = (t + self.delay_sym) // SYMBOLS_PER_SLOT
                s_db = float(snr_db[slot, row]) if slot < snr_db.shape[0] \
                    else 0.0
                le_last[r] = t + SYMBOLS_LE_PREAMBLE_AA
                le_hits.append(LeHit(channel=ch, freq=2402e6 + ch * 1e6,
                                     index=index,
                                     clkn=(slot_base + slot) & 0x7FFFFFF,
                                     sym_offset=t, distance=dist,
                                     snr_db=s_db, win_row=int(k)))
        else:
            le_windows = np.zeros((0, LE_WIN_SYMBOLS // 32 + 1), np.int32)
        return BlockResult(slot_base=slot_base, snr_db=snr_db, hits=hits,
                           le_hits=le_hits, windows=windows,
                           le_windows=le_windows, n_slots=self.block_slots)

    @staticmethod
    def _unpack_window(row: np.ndarray, n: int) -> np.ndarray:
        """Window rows arrive bit-aligned from the device."""
        bits = np.unpackbits(np.ascontiguousarray(row).view(np.uint8),
                             bitorder="little")
        return bits[:n].astype(np.int8)

    def packet_symbols(self, res: BlockResult, hit: Hit) -> np.ndarray:
        """Symbol window for a hit (up to 5 slots), for packet decode."""
        n = min(WIN_SYMBOLS, self.n_sym - hit.sym_offset)
        return self._unpack_window(res.windows[hit.win_row], n)

    def packet_symbols_matrix(self, res: BlockResult):
        """All classic hits' symbol windows at once: (K, WIN_SYMBOLS)
        uint8 plus per-row valid symbol counts — one unpackbits over the
        block's window table."""
        K = len(res.hits)
        if K == 0:
            return (np.zeros((0, WIN_SYMBOLS), np.uint8),
                    np.zeros(0, np.int64))
        rows = np.array([h.win_row for h in res.hits])
        w = np.ascontiguousarray(res.windows[rows])    # hits' rows only
        allbits = np.unpackbits(w.view(np.uint8).reshape(K, -1),
                                axis=1, bitorder="little")
        sym = allbits[:, :WIN_SYMBOLS]
        sizes = np.array([min(WIN_SYMBOLS, self.n_sym - h.sym_offset)
                          for h in res.hits], dtype=np.int64)
        return sym, sizes

    def le_packet_symbols(self, res: BlockResult, hit: LeHit) -> np.ndarray:
        """Symbol window for an LE hit."""
        n = min(LE_WIN_SYMBOLS, self.n_sym - hit.sym_offset)
        return self._unpack_window(res.le_windows[hit.win_row], n)

    def _host_planes(self, samples) -> np.ndarray:
        """Host capture -> (2, N) float32 planes at the bank's rate
        (resampled first at off-grid rates)."""
        samples = np.asarray(samples)
        if np.iscomplexobj(samples):
            samples = np.stack([samples.real, samples.imag]).astype(np.float32)
        if self.resampler is not None:
            samples = self.resampler(samples)
        return samples

    def stream(self, samples, start_clkn: int = 0, wire: str = "f32"):
        """Iterate BlockResults over a long capture (host numpy input).

        The production pipelined path (io.ingest) through the fused
        chain (the conv-bank step at odd rates): the overlap-save carry
        lives on the device, each block's H2D copy carries only
        step_samples of new data in the given wire format, and later
        blocks are launched before earlier blocks' outputs are read.
        Block placement equals stream_sync's."""
        from ..io.ingest import PipelinedIngest, wire_chunks
        from ..utils.metrics import metrics

        samples = self._host_planes(samples)
        ingest = self._ingests.get(wire)
        if ingest is None:
            ingest = self._ingests[wire] = PipelinedIngest(self, wire)
        with metrics.stage("wire_encode"):
            carry, chunks = wire_chunks(samples, self, wire, pad_tail=True)
        return ingest.run(chunks, start_clkn, initial_carry=carry)

    def stream_sync(self, samples, start_clkn: int = 0):
        """Synchronous block loop through the flat chain (one blocking
        copy + step + fetch per block) — the parity reference for
        stream()."""
        samples = self._host_planes(samples)
        pos = 0
        slot_base = start_clkn
        n = samples.shape[1]
        while pos + self.block_samples <= n:
            yield self.process_block(samples[:, pos:pos + self.block_samples],
                                     slot_base)
            pos += self.step_samples
            slot_base += self.block_slots
        # tail: pad the final partial block with zeros
        if pos < n:
            tail = np.zeros((2, self.block_samples), dtype=np.float32)
            tail[:, :n - pos] = samples[:, pos:]
            yield self.process_block(tail, slot_base)


def _planes(x) -> torch.Tensor:
    """Samples -> (2, N) float32 planes on their own device (the CPU for
    host arrays): complex (N,) arrays are split, planes pass through."""
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            x = torch.stack([x.real, x.imag])
        return x.to(torch.float32)
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag])
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def ac_product_consts(a68=detect_kernel.A68, c68v=detect_kernel.C68V):
    """The affine access-code map as the hit rows' float32 product takes
    it: ac_a68t (24, 68) = A68 transposed, ac_c68 (68,) = C68."""
    return dict(ac_a68t=np.ascontiguousarray(
                    (np.asarray(a68)[:68] & 1).T.astype(np.float32)),
                ac_c68=(np.asarray(c68v)[:68] & 1).astype(np.float32))


def le_step_consts(white, aa_on, max_dist, *, n_sym: int,
                   delay_sym: int) -> dict:
    """The LE branch's constants besides le_rows, from le_row_consts'
    (white, aa_on, max_dist): the packed whitening words, aa_on and
    max_dist, the squelch word constants for the n_sym - 55 LE offsets
    and the distance tables."""
    s0, ma = _word_slot_consts(-(-(n_sym - detect.LE_SPAN + 1) // 32),
                               delay_sym)
    return dict(le_white_word=detect.le_white_words(white), le_aa_on=aa_on,
                le_max_dist=max_dist, le_word_s0=s0, le_word_mask_a=ma,
                **detect.le_table_consts())


def consts_to_device(consts: dict, device) -> dict:
    """Numpy bank/detector constants -> the step's tensors on `device`
    (word_s0 and le_word_s0 as int64 indices, the rest in their own
    dtypes)."""
    out = {}
    for k, v in consts.items():
        v = np.asarray(v)
        if k in ("word_s0", "le_word_s0"):
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out


def _extract_hits(mask, max_hits: int, payload_cols):
    """Dense (C, n) mask -> the first max_hits set elements in
    channel-major order, with no host sync: an inclusive prefix sum over
    the flat mask, and searchsorted places each rank r.

    Returns (count, tab, chan, off, valid): tab is (max_hits,
    2 + len(payload_cols)) int32 rows [chan, offset, *payload], -1 on
    rows r >= count; count may exceed max_hits."""
    C, n = mask.shape
    flat = mask.reshape(-1).to(torch.int64)
    cum = torch.cumsum(flat, 0)
    count = cum[-1]
    r = torch.arange(max_hits, device=mask.device)
    idx = torch.searchsorted(cum, r, right=True).clamp(max=flat.numel() - 1)
    valid = r < count
    chan, off = idx // n, idx % n
    cols = [chan, off] + [p.reshape(-1)[idx] for p in payload_cols]
    tab = torch.stack([c.to(torch.int32) for c in cols], 1)
    tab = torch.where(valid[:, None], tab, -1)
    return count.to(torch.int32), tab, chan, off, valid


def _squelch_gate(snr_db, n: int, delay_sym: int, squelch: float):
    """(S, C) slot SNR -> (C, n) per-offset boolean gate: offset t sits in
    slot (t + delay_sym) // 625, slots past S read as slot S-1."""
    S, C = snr_db.shape
    rep = (snr_db.T >= squelch).repeat_interleave(SYMBOLS_PER_SLOT, 1)
    pad = max(0, delay_sym + n - S * SYMBOLS_PER_SLOT)
    if pad:
        rep = torch.cat([rep, rep[:, -1:].expand(C, pad)], 1)
    return rep[:, delay_sym: delay_sym + n]


def _unpack_word_rows(words, rows, n_sym: int):
    """Dense 0/1 int64 symbol rows for the selected rows of a packed word
    plane: (C, W) int32, (R,) -> (R, n_sym)."""
    sel = words[rows].to(torch.int64) & _M32
    b = (sel[:, :, None] >> torch.arange(32, device=words.device)) & 1
    return b.reshape(sel.shape[0], -1)[:, :n_sym]


def _word_slot_consts(n_words: int, delay_sym: int):
    """Static per-word slot indices + intra-word slot-boundary masks for
    _squelch_gate_words."""
    w = np.arange(n_words, dtype=np.int64)
    first = 32 * w + delay_sym                     # offset+delay of bit 0
    s0 = first // SYMBOLS_PER_SLOT
    boundary = (s0 + 1) * SYMBOLS_PER_SLOT - first  # bits before next slot
    bp = np.clip(boundary, 0, 32)
    mask_a = np.where(bp >= 32, np.int64(0xFFFFFFFF), (1 << bp) - 1)
    return (s0.astype(np.int32),
            mask_a.astype(np.int64).astype(np.uint32).view(np.int32))


def step_geometry(n_samples: int, Q: int, decim: int, n_sym: int,
                  slot_ch: int, taps_len: int):
    """Sizes of one block's step: (n, n_data, S, n_k, n_frames).

    n true channel frames (frame j reads input frames j .. j+2Q-1);
    n_data demod groups that start inside them (later groups give
    all-ones words, as the TPU megakernel's tiles past the data do);
    S slots; n_k probe grid points; n_frames channel frames pfb_snr
    computes, from zeros past the data: enough for every data group's
    window and every slot, rounded up to whole tiles."""
    G = demod_kernel.GROUP_FRAMES
    n = n_samples // decim - 2 * Q
    n_data = -(-n // G)
    S = n // slot_ch
    n_k = snr.probe_points(S, slot_ch, taps_len)
    n_t = demod_kernel.n_groups(n_sym, n_k)
    need = max(G * min(n_data, n_t) + 2, S * slot_ch)
    n_frames = -(-need // pfb_kernel.TF) * pfb_kernel.TF
    return n, n_data, S, n_k, n_frames


def _device_step(x_ri, *, h0, h1, dft_c, dft_s, bin_odd, probe_re,
                 probe_im, decim, n_sym, n_y, slot_ch, kappa, demod_gain,
                 **tail):
    """The flat chain: (2, N) float32 block on the device -> (snr_db,
    n_hits, tab, windows, n_le, le_tab, le_windows), as
    gr_bluetooth_tpu's _device_step on flat planes with use_pallas."""
    n = x_ri.shape[1] // decim - 2 * h0.shape[0]
    if n != n_y:
        raise ValueError(f"block of {x_ri.shape[1]} samples gives {n} "
                         f"frames, the front end expects {n_y}")
    yr, yi = pfb._pfb_impl(x_ri, h0, h1, dft_c, dft_s, bin_odd)
    snr_db, _, _ = snr.stream_snr(yr, yi, probe_re, probe_im,
                                  slot_ch=slot_ch, kappa=kappa)
    _, bits = demod.demod_and_slice(yr[:-1], yi[:-1], demod_gain, 2.0, n_sym)
    words = detect_kernel.pack_bits_words(bits)
    return _packed_tail(words, snr_db, n_sym=n_sym, **tail)


def _conv_step(x_ri, *, kernel, rot_q, on_w, off_w, decim, sps, ch_sps,
               demod_gain, n_sym, slot_len, **tail):
    """The odd-integer rates' step: (2, N) float32 block on the device ->
    the step's 7-tuple, as gr_bluetooth_tpu's _device_step with is_pfb
    false and use_pallas (frontend.py:723-726, 747-751): the conv bank
    and the slot SNR, the torch demod at ch_sps samples per symbol, its
    bits packed for detect_words."""
    yr, yi = channelizer._channelize_impl(x_ri[None], kernel, rot_q, 0,
                                          decim=decim, sps=sps)
    snr_db, _, _ = snr._slot_snr_impl(x_ri, on_w, off_w, slot_len)
    _, bits = demod.demod_and_slice(yr, yi, demod_gain, ch_sps, n_sym)
    words = detect_kernel.pack_bits_words(bits)
    return _packed_tail(words, snr_db, n_sym=n_sym, **tail)


def _fused_step(x_ri, *, h0, h1, dft_c, dft_s, bin_odd, probe_re, probe_im,
                decim, n_sym, n_y, slot_ch, kappa, demod_gain, **tail):
    """The fused chain: same input and outputs as _device_step, as
    gr_bluetooth_tpu's _device_step on its staged Pallas branch."""
    n, n_data, S, n_k, n_frames = step_geometry(
        x_ri.shape[1], h0.shape[0], decim, n_sym, slot_ch,
        probe_re.shape[0])
    if n != n_y:
        raise ValueError(f"block of {x_ri.shape[1]} samples gives {n} "
                         f"frames, the front end expects {n_y}")

    yr, yi, oe = pfb_kernel.pfb_snr(x_ri, h0, h1, dft_c, dft_s, bin_odd,
                                    n_frames)
    words, pe = demod_kernel.demod_pack(yr, yi, demod_gain, n_sym, probe_re,
                                        probe_im, n_k, n_data)
    snr_db = snr.assemble_slot_snr(oe, pe, S=S, slot_ch=slot_ch,
                                   kappa=kappa, tile=pfb_kernel.TF)
    # drop the probe row
    return _packed_tail(words[:-1], snr_db, n_sym=n_sym, **tail)


def _packed_tail(words, snr_db, *, ac_masks, ac_a68t, ac_c68, word_s0,
                 word_mask_a, n_sym, max_ac_errors, delay_sym, squelch,
                 max_hits, max_le_hits, le_rows=None, **le_consts):
    """Both chains' tail (gr_bluetooth_tpu/models/frontend.py:750-808):
    (C, W) packed words, (S, C) slot SNR -> the step's 7-tuple:
    detect_words, with LE on le_detect, then hit_table over the hit
    planes (squelch, extraction, windows and the rows in one kernel; with
    LE on both tails in one launch, hit_tables).  The group delay
    (delay_sym, a static of every step) is built into the squelch word
    constants."""
    del delay_sym
    hitw, _, _ = detect_kernel.detect_words(words, n_sym - 72 + 1,
                                            max_ac_errors, ac_masks)
    classic = dict(hitw=hitw, words=words, rows=None, snr_db=snr_db,
                   word_s0=word_s0, word_mask_a=word_mask_a,
                   squelch=squelch, max_hits=max_hits,
                   ac=dict(ac_a68t=ac_a68t, ac_c68=ac_c68,
                           ac_masks=ac_masks))
    if le_rows is None:
        return (snr_db, *hit_table.hit_table(**classic), None, None, None)
    cls, le = hit_table.hit_tables(classic, _le_args(
        words, snr_db, le_rows, n_sym=n_sym, squelch=squelch,
        max_le_hits=max_le_hits, **le_consts))
    return (snr_db, *cls, *le)


def _le_args(words, snr_db, le_rows, *, n_sym, squelch, max_le_hits,
             le_white_word, le_aa_on, le_max_dist, le_word_s0,
             le_word_mask_a, **le_tables):
    """The LE branch on packed planes (gr_bluetooth_tpu/models/
    frontend.py:797-808) up to its table: le_detect's hit plane (hits
    only) and hit_table's LE arguments over it, as a dict: the packed
    squelch gate of the LE rows, the first max_le_hits hits in row-major
    order (n_le counts them all), their windows and their distances."""
    hitw, _ = detect.le_detect(words, le_rows, n_sym, le_white_word,
                               le_aa_on, le_max_dist, with_dist=False,
                               **le_tables)
    return dict(hitw=hitw, words=words, rows=le_rows, snr_db=snr_db,
                word_s0=le_word_s0, word_mask_a=le_word_mask_a,
                squelch=squelch, max_hits=max_le_hits,
                le=dict(le_white_word=le_white_word, le_aa_on=le_aa_on,
                        **le_tables))


def _le_tail(words, snr_db, le_rows, **le_consts):
    """The LE branch alone: (n_le, le_tab, le_windows), hit_table over
    _le_args' plane."""
    return hit_table.hit_table(**_le_args(words, snr_db, le_rows,
                                          **le_consts))
