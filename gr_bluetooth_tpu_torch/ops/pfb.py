"""Polyphase DFT filterbank constants (the bank the CUDA channelizer runs).

    y_c[n] = e^{-j2pi c nD/M} * DFT_M{ u_r[n] }_c
    u_r[n] = sum_q h[qM + r] x[nD + qM + r]

with M = fs / 1 MHz branches and D = M/2 decimation (2 samples/symbol
out).  Because D = M/2 the rotator collapses to (-1)^{c n}: a sign flip
on odd bins at odd frames.  The prototype is the reference's Hann
low-pass (500 kHz cutoff / 300 kHz transition, multi_block.cc:62-69).

The bank constructor is a copy of gr_bluetooth_tpu/ops/pfb.py's.  The
flat-input channelizer is deinterleave (the port of the TPU kernel
gr_bluetooth_tpu/ops/pfb.py:_deinterleave, CUDA kernel
csrc/deinterleave.cu) followed by ops/pfb_kernel.py:pfb_channelize;
pfb_channelize below is the public entry point over both.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (BASE_FREQUENCY, CHANNEL_FILTER_CUTOFF,
                         CHANNEL_FILTER_TRANSITION, CHANNEL_WIDTH)
from .channelizer import select_channels
from ..utils import cuda_build
from . import pfb_kernel
from .filters import lowpass_taps

__all__ = ["PfbBank", "deinterleave", "deinterleave_plain", "make_pfb_bank",
           "pfb_channelize"]


@dataclass(frozen=True)
class PfbBank:
    fs: float
    center_freq: float
    sps: int                      # wideband samples per symbol = M branches
    decim: int                    # D = M/2
    ch_sps: float                 # always 2.0
    channels: tuple               # BR channel numbers covered
    ntaps: int                    # prototype length before padding
    h0: np.ndarray                # (Q, D) branch taps, even half-frames
    h1: np.ndarray                # (Q, D) branch taps, odd half-frames
    dft_c: np.ndarray             # (M, C) cos DFT columns for covered bins
    dft_s: np.ndarray             # (M, C) sin DFT columns for covered bins
    bin_odd: np.ndarray           # (C,) float32: 1.0 where DFT bin is odd
    demod_gain: float

    @property
    def n_channels(self) -> int:
        return len(self.channels)


def make_pfb_bank(fs: float, center_freq: float,
                  channels: tuple | None = None) -> PfbBank:
    sps = int(round(fs / 1e6))
    if abs(fs - sps * 1e6) > 1e-3 or sps < 2:
        raise ValueError("sample rate must be an integer multiple of 1 Msps >= 2")
    if sps % 2:
        raise ValueError("polyphase bank requires an even samples/symbol; "
                         "use the conv bank for odd rates")
    if abs((center_freq / 1e6) - round(center_freq / 1e6)) > 1e-9:
        raise ValueError("center frequency must sit on the 1 MHz channel grid")
    M = sps
    D = M // 2

    # channels may be overridden by resampled front ends whose TRUE band
    # is narrower than the internal rate (ops/resample.py)
    channels = tuple(channels) if channels else \
        select_channels(fs, center_freq)
    # one extra "probe row" above the top channel: the off-channel noise
    # probe at f_c + 790 kHz (multi_block.cc:71-79, 336-340) sits at
    # -210 kHz inside channel c+1's passband, so the SNR squelch reads it
    # from the neighbor's stream (ops/snr.py) — rows = channels + [high+1]
    probe_rows = channels + (channels[-1] + 1,)

    taps = lowpass_taps(1.0, fs, CHANNEL_FILTER_CUTOFF,
                        CHANNEL_FILTER_TRANSITION)
    ntaps = len(taps)
    Q = -(-ntaps // M)                                 # half-frames, ceil
    h = np.zeros(Q * M, dtype=np.float64)
    h[:ntaps] = taps
    hm = h.reshape(Q, M)
    h0 = hm[:, :D].astype(np.float32)                  # h[qM + p]
    h1 = hm[:, D:].astype(np.float32)                  # h[qM + p + D]

    C = len(probe_rows)
    r = np.arange(M)
    dft_c = np.zeros((M, C), dtype=np.float32)
    dft_s = np.zeros((M, C), dtype=np.float32)
    bin_odd = np.zeros(C, dtype=np.float32)
    for i, ch in enumerate(probe_rows):
        f_rel = BASE_FREQUENCY + ch * CHANNEL_WIDTH - center_freq
        m = int(round(f_rel / 1e6)) % M                # DFT bin
        ang = 2.0 * np.pi * m * r / M
        dft_c[:, i] = np.cos(ang)
        dft_s[:, i] = np.sin(ang)
        bin_odd[i] = float(m & 1)
    demod_gain = 2.0 / (np.pi / 2.0)                   # ch_sps / (pi/2)
    return PfbBank(fs, center_freq, sps, D, 2.0, channels, ntaps,
                   h0, h1, dft_c, dft_s, bin_odd, float(demod_gain))


def deinterleave_plain(x, D: int):
    """Plain PyTorch version of deinterleave (same arguments and
    results), as D strided slices of the planes."""
    n_x = x.shape[1] // D
    return torch.stack([x[:, d: n_x * D: D] for d in range(D)], 1)


def _deint_launcher():
    fn = cuda_build.load("deinterleave").deinterleave_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, L, I, I, P, P]
        fn.restype = ctypes.c_int
    return fn


def deinterleave(x, D: int):
    """(2, N) float32 planes -> (2, D, n_x) float32, n_x = N // D:
    xp[p, d, j] = x[p, j*D + d] (samples past n_x*D are dropped).  A CPU
    tensor runs the plain version; a CUDA tensor launches
    csrc/deinterleave.cu (counted in deinterleave.launches)."""
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[0] != 2:
        raise TypeError(f"deinterleave: x must be (2, N) float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if D <= 0 or x.shape[1] < D:
        raise ValueError(f"deinterleave: need 0 < D <= N, got D={D}, "
                         f"N={x.shape[1]}")
    if x.device.type == "cpu":
        return deinterleave_plain(x, D)
    if x.device.type != "cuda":
        raise ValueError(f"deinterleave: unsupported device {x.device}")
    x = x.contiguous()
    n_x = x.shape[1] // D
    out = torch.empty((2, D, n_x), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _deint_launcher()(x.data_ptr(), x.shape[1], n_x, D,
                               out.data_ptr(), stream)
    cuda_build.check(rc, "deinterleave")
    deinterleave.launches += 1
    return out


deinterleave.launches = 0


def _pfb_impl(x_ri, h0, h1, dft_c, dft_s, bin_odd):
    """(2, N) float32 planes on a device -> (yr, yi) (C, n) channel
    streams, n = N // D - 2Q: deinterleave, then pfb_channelize."""
    D = h0.shape[1]
    return pfb_kernel.pfb_channelize(deinterleave(x_ri, D), h0, h1, dft_c,
                                     dft_s, bin_odd)


def pfb_channelize(x, bank: PfbBank):
    """x: complex (N,) or (2, N) float32 planes, numpy or a tensor.
    Returns (yr, yi) float32 (C + 1, n) decimated channel streams (the
    probe row last) on x's device (the CPU for numpy input)."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x = np.stack([x.real, x.imag])
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    elif x.is_complex():
        x = torch.stack([x.real, x.imag])
    x = x.to(torch.float32)
    consts = (torch.from_numpy(np.array(a, copy=True)).to(x.device)
              for a in (bank.h0, bank.h1, bank.dft_c, bank.dft_s,
                        bank.bin_odd))
    return _pfb_impl(x, *consts)
