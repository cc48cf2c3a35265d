"""Per-slot, per-channel SNR squelch from the channel streams.

On-channel energy is mean |y|^2 over the slot, straight from the channel
streams (the reference's definition, lib/multi_block.cc:180-228).  The
off-channel probe at f_c + 790 kHz (multi_block.cc:253-296) is read at
-210 kHz inside channel c+1's stream: a short complex band-pass at the
2 Msps channel rate, evaluated on a 40-frame grid, rescaled by `kappa` to
the reference's 22.5 kHz full-rate probe so the on/off ratio (and the
10 dB squelch) keeps its meaning on a flat noise floor.

The constants are a copy of gr_bluetooth_tpu/ops/snr.py's
make_stream_snr_consts.  Two ways to the same (S, C) slot SNR:

  * the fused chain's partials come from the kernels
    (ops/pfb_kernel.pfb_snr's per-tile energies,
    ops/demod_kernel.demod_pack's probe energies); `assemble_slot_snr`
    groups them as gr_bluetooth_tpu/ops/snr.py:assemble_fused_snr does;
  * the flat chain reads the channel streams themselves: `stream_snr`
    is gr_bluetooth_tpu/ops/snr.py:_stream_snr_impl, torch code (the JAX
    package computes it outside any Pallas kernel).  Its probe
    contraction is an FP32 matmul: TF32 is off for it alone
    (utils/device.fp32_matmul), whatever the caller has set.

The odd-integer rates' conv bank (ops/channelizer.py) has no probe row,
so its squelch reads the wideband block itself, as
gr_bluetooth_tpu/ops/snr.py:_slot_snr_impl does: by Parseval, mean
|x*h|^2 = (1/L^2) sum_f |X_f|^2 |H_f|^2, so one L-point FFT per slot
gives every channel's on- and off-band energy as two FP32 matmuls,
P @ on_w and P @ off_w, against precomputed |H|^2 columns
(`make_snr_weights`, a copy of the JAX package's NumPy code).  The FFT
is torch.fft.fft (XLA's FFT in the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (BASE_FREQUENCY, CHANNEL_FILTER_CUTOFF,
                         CHANNEL_FILTER_TRANSITION, CHANNEL_WIDTH,
                         NOISE_FILTER_CUTOFF, NOISE_FILTER_TRANSITION,
                         NOISE_PROBE_OFFSET, SYMBOLS_PER_SLOT)
from ..utils.device import fp32_matmul, resolve_device
from .channelizer import ChannelBank
from .filters import lowpass_taps

__all__ = ["PROBE_STRIDE", "SnrWeights", "StreamSnrConsts",
           "assemble_slot_snr", "make_snr_weights", "make_stream_snr_consts",
           "probe_points", "slot_snr", "stream_snr"]

PROBE_STRIDE = 40                       # probe energy samples per slot: ~31


@dataclass(frozen=True)
class SnrWeights:
    slot_len: int                 # wideband samples per slot
    on_w: np.ndarray              # (L, C) float32
    off_w: np.ndarray             # (L, C) float32


def _shifted_response(taps: np.ndarray, L: int, f_rel: float,
                      fs: float) -> np.ndarray:
    """|H(f - f_rel)|^2 sampled at the L FFT bins of rate fs:
    H(f_k - f_rel) = FFT{ h[t] e^{+j 2 pi f_rel t / fs} }[k], exact for
    any (fractional-bin) shift at O(L log L)."""
    t = np.arange(len(taps))
    mod = taps * np.exp(2j * np.pi * (f_rel / fs) * t)
    return np.abs(np.fft.fft(mod, L)) ** 2


def make_snr_weights(bank: ChannelBank) -> SnrWeights:
    L = SYMBOLS_PER_SLOT * bank.sps
    ch_taps = lowpass_taps(1.0, bank.fs, CHANNEL_FILTER_CUTOFF,
                           CHANNEL_FILTER_TRANSITION)
    nz_taps = lowpass_taps(1.0, bank.fs, NOISE_FILTER_CUTOFF,
                           NOISE_FILTER_TRANSITION)
    C = bank.n_channels
    on_w = np.zeros((L, C), dtype=np.float32)
    off_w = np.zeros((L, C), dtype=np.float32)
    for i, ch in enumerate(bank.channels):
        f_rel = BASE_FREQUENCY + ch * CHANNEL_WIDTH - bank.center_freq
        on_w[:, i] = _shifted_response(ch_taps, L, f_rel, bank.fs)
        off_w[:, i] = _shifted_response(nz_taps, L, f_rel + NOISE_PROBE_OFFSET,
                                        bank.fs)
    return SnrWeights(L, on_w, off_w)


def _slot_snr_impl(x_ri, on_w, off_w, slot_len: int):
    """x_ri (2, N) float32 IQ planes, on_w/off_w (L, C) -> (snr_db, on,
    off), each (S, C), S = N // slot_len."""
    n_slots = x_ri.shape[1] // slot_len
    xs = x_ri[:, : n_slots * slot_len].reshape(2, n_slots, slot_len)
    X = torch.fft.fft(torch.complex(xs[0], xs[1]))
    P = X.real ** 2 + X.imag ** 2
    scale = 1.0 / (slot_len * slot_len)
    with fp32_matmul():
        on = (P @ on_w) * scale
        off = (P @ off_w) * scale
    snr_db = 10.0 * (torch.log10(torch.clamp(on, min=1e-30)) -
                     torch.log10(torch.clamp(off, min=1e-30)))
    return snr_db, on, off


def slot_snr(x, weights: SnrWeights, device=None):
    """x: complex wideband block or (2, N) float32 planes (numpy or
    torch); returns (snr_db, on, off), each (S, C), on `device` (the
    card unless the caller names another)."""
    device = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x = np.stack([x.real, x.imag])
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    elif x.is_complex():
        x = torch.stack([x.real, x.imag])
    x = x.to(device, torch.float32)
    return _slot_snr_impl(x, torch.from_numpy(weights.on_w).to(device),
                          torch.from_numpy(weights.off_w).to(device),
                          weights.slot_len)


@dataclass(frozen=True)
class StreamSnrConsts:
    """Constants for the stream-based squelch (no FFT, no full-rate FIRs)."""
    slot_ch: int                  # channel-rate samples per slot
    taps_re: np.ndarray           # (T,) probe band-pass, real part
    taps_im: np.ndarray           # (T,) probe band-pass, imag part
    kappa: float


def make_stream_snr_consts(bank) -> StreamSnrConsts:
    ch_fs = bank.fs / bank.decim
    slot_ch = int(round(SYMBOLS_PER_SLOT * bank.ch_sps))
    # 2x the reference's 10 kHz transition: halves the tap count; kappa
    # below renormalizes the equivalent noise bandwidth so the on/off ratio
    # (and the 10 dB squelch meaning) is unchanged on a flat floor
    g = lowpass_taps(1.0, ch_fs, NOISE_FILTER_CUTOFF,
                     2.0 * NOISE_FILTER_TRANSITION)
    t = np.arange(len(g))
    theta = -2.0 * np.pi * ((NOISE_PROBE_OFFSET - CHANNEL_WIDTH) / ch_fs) * t
    taps_re = (g * np.cos(theta)).astype(np.float32)
    taps_im = (g * np.sin(theta)).astype(np.float32)
    # reference probe: 22.5 kHz cut / 10 kHz transition at the full rate
    h_ref = lowpass_taps(1.0, bank.fs, NOISE_FILTER_CUTOFF,
                         NOISE_FILTER_TRANSITION)
    h_ch = lowpass_taps(1.0, bank.fs, CHANNEL_FILTER_CUTOFF,
                        CHANNEL_FILTER_TRANSITION)
    # white-noise energies: reference off = sigma^2 sum h_ref^2 ; ours =
    # sigma^2 sum h_ch^2 * sum g^2 (probe runs on the channelized stream)
    kappa = float(np.sum(h_ref ** 2) /
                  (np.sum(h_ch ** 2) * np.sum(g ** 2)))
    return StreamSnrConsts(slot_ch, taps_re, taps_im, kappa)


def probe_points(S: int, slot_ch: int, taps_len: int) -> int:
    """Probe grid points the S-slot assembly reads: every window
    [40k, 40k + Tp) inside the first S slots, Tp the tap count rounded
    up to the stride."""
    Tp = -(-taps_len // PROBE_STRIDE) * PROBE_STRIDE
    n_k = (S * slot_ch - Tp) // PROBE_STRIDE + 1
    if n_k < 1:
        raise ValueError("block too short for the probe band-pass")
    return n_k


def assemble_slot_snr(oe, pe, *, S: int, slot_ch: int, kappa: float,
                      tile: int):
    """(S, C) slot SNR in dB from the kernels' partials.

    oe (C+1, G) on-energy sums over `tile`-frame tiles (tile divides
    slot_ch); pe (C+1, n_k) probe energies on the 40-frame grid.  Row
    C is the probe row above the top channel: channel c's noise comes
    from row c+1.  on = slot mean of |y|^2; off = mean of the probe
    energies k in [31s, 31s + 31), the slots past the last full group
    edge-padded from it, times kappa."""
    if slot_ch % tile:
        raise ValueError(f"tile {tile} does not divide slot_ch {slot_ch}")
    Cp, G = oe.shape
    C = Cp - 1
    # segment sums as reshaped sums, in a fixed order: the same bits at
    # every run (an index_add_ on a card adds in no fixed order)
    per_tile = slot_ch // tile
    oe = torch.nn.functional.pad(oe[:C], (0, max(0, S * per_tile - G)))
    on = oe[:, : S * per_tile].reshape(C, S, per_tile).sum(-1).T / slot_ch

    n_k = pe.shape[1]
    per_slot = slot_ch // PROBE_STRIDE
    Sp = min(S, n_k // per_slot)
    off = pe[1:C + 1, : Sp * per_slot].reshape(C, Sp, per_slot).sum(-1).T
    off = off / per_slot
    if Sp < S:
        off = torch.cat([off, off[-1:].expand(S - Sp, C)], 0)
    off = off * kappa
    return 10.0 * (torch.log10(torch.clamp(on, min=1e-30)) -
                   torch.log10(torch.clamp(off, min=1e-30)))


def _probe_grid(yr, yi, taps_re, taps_im):
    """Probe band-pass energy at every PROBE_STRIDE-grid position of the
    given complex streams: (R, n) -> (R, np_), np_ = (n - Tp)//stride + 1,
    taps zero-padded to Tp, a multiple of the stride.  The strided
    convolution as (R, n/40, 40) @ (40, A) matmuls plus a diagonal sum,
    as gr_bluetooth_tpu/ops/snr.py:_probe_grid computes it."""
    R, n = yr.shape
    T = taps_re.shape[0]
    A = -(-T // PROBE_STRIDE)
    Tp = A * PROBE_STRIDE
    tr = torch.nn.functional.pad(taps_re, (0, Tp - T)).reshape(
        A, PROBE_STRIDE).T
    ti = torch.nn.functional.pad(taps_im, (0, Tp - T)).reshape(
        A, PROBE_STRIDE).T
    m40 = n // PROBE_STRIDE
    np_ = (n - Tp) // PROBE_STRIDE + 1
    yv_r = yr[:, : m40 * PROBE_STRIDE].reshape(R, m40, PROBE_STRIDE)
    yv_i = yi[:, : m40 * PROBE_STRIDE].reshape(R, m40, PROBE_STRIDE)

    def dsum(m):                                           # (R, m40, A)
        acc = m[:, 0:np_, 0]
        for a in range(1, A):
            acc = acc + m[:, a: a + np_, a]
        return acc                                         # (R, np_)

    with fp32_matmul():
        p_re = dsum(yv_r @ tr) - dsum(yv_i @ ti)
        p_im = dsum(yv_r @ ti) + dsum(yv_i @ tr)
    return p_re ** 2 + p_im ** 2


def stream_snr(yr, yi, taps_re, taps_im, *, slot_ch: int, kappa: float):
    """(C+1, n) channel streams (last row = the probe row above the top
    channel) -> (snr_db, on, off), each (S, C), S = n // slot_ch.

    on = slot mean of |y|^2; off = slot mean (31 grid points per slot) of
    the probe energies of row c+1, slots past the last full group
    edge-padded from it, times kappa."""
    Cp, n = yr.shape
    C = Cp - 1
    S = n // slot_ch
    m = S * slot_ch
    on = (yr[:C, :m] ** 2 + yi[:C, :m] ** 2).reshape(C, S, slot_ch).mean(-1)
    pe = _probe_grid(yr[1:, :m], yi[1:, :m], taps_re, taps_im)
    per_slot = slot_ch // PROBE_STRIDE
    Sp = min(S, pe.shape[1] // per_slot)
    off = pe[:, : Sp * per_slot].reshape(C, Sp, per_slot).mean(-1)
    if Sp < S:
        off = torch.cat([off, off[:, -1:].expand(C, S - Sp)], 1)
    off = off * kappa
    snr_db = 10.0 * (torch.log10(torch.clamp(on, min=1e-30)) -
                     torch.log10(torch.clamp(off, min=1e-30)))
    return snr_db.T, on.T, off.T
