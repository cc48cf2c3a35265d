"""Wideband -> per-channel DDC bank as one strided convolution (the odd
integer rates' channelizer), and the channel selection every bank uses.

All channels are one batched strided convolution over the (re, im)
planes:

    y_c[n] = rot_c[n] * sum_t  h[t] e^{-j 2 pi f_c t / fs}  x[nD + t]

a conv1d with stride D, 2 input and 2C output features.  The per-output
phase rotator is exact integer modular arithmetic (f_c * D / fs is
rational with denominator sps on the 1 MHz channel grid), so there is no
float32 phase drift over long streams.  Filter design and channel
selection mirror multi_block (multi_block.cc:62-84, 305-342): Hann
low-pass, 500 kHz cutoff / 300 kHz transition, D = floor(sps/2),
channels fitting in bandwidth with >= 0.9 MHz margin.

The port of gr_bluetooth_tpu/ops/channelizer.py.  The JAX package runs
the convolution as XLA's conv_general_dilated, not a Pallas kernel; here
it is torch's conv1d (cuDNN on a card), run in FP32 whatever the
caller's TF32 setting (utils/device.fp32_matmul): single-pass TF32
would break the channel streams' 2e-5 bound.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (BASE_FREQUENCY, CHANNEL_FILTER_CUTOFF,
                         CHANNEL_FILTER_TRANSITION, CHANNEL_WIDTH)
from ..utils.device import fp32_matmul, resolve_device
from .filters import lowpass_taps

__all__ = ["ChannelBank", "make_bank", "channelize", "select_channels"]


def select_channels(fs: float, center_freq: float) -> tuple:
    """BR channels fitting in bandwidth with >= 0.9 MHz margin
    (multi_block.cc:305-324)."""
    center = (center_freq - BASE_FREQUENCY) / CHANNEL_WIDTH
    bw = fs / CHANNEL_WIDTH
    low = max(0, int(center - bw / 2 + 0.45 + 1))
    high = min(78, int(center + bw / 2 - 0.45))
    if high < low:
        raise ValueError("no BR channels fit in this bandwidth")
    return tuple(range(low, high + 1))


@dataclass(frozen=True)
class ChannelBank:
    fs: float
    center_freq: float
    sps: int                      # wideband samples per symbol
    decim: int                    # DDC decimation D = sps // 2
    ch_sps: float                 # channel-rate samples per symbol
    channels: tuple               # BR channel numbers covered
    ntaps: int
    kernel: np.ndarray            # (2C, 2, T) float32 conv kernel
    rot_q: np.ndarray             # (C,) int32: per-channel rotator step mod sps
    demod_gain: float

    @property
    def n_channels(self) -> int:
        return len(self.channels)


def make_bank(fs: float, center_freq: float) -> ChannelBank:
    sps = int(round(fs / 1e6))
    if abs(fs - sps * 1e6) > 1e-3 or sps < 2:
        raise ValueError("sample rate must be an integer multiple of 1 Msps >= 2")
    if abs((center_freq / 1e6) - round(center_freq / 1e6)) > 1e-9:
        raise ValueError("center frequency must sit on the 1 MHz channel grid")
    decim = sps // 2
    ch_sps = sps / decim
    channels = select_channels(fs, center_freq)

    taps = lowpass_taps(1.0, fs, CHANNEL_FILTER_CUTOFF, CHANNEL_FILTER_TRANSITION)
    T = len(taps)
    t = np.arange(T)
    C = len(channels)
    kernel = np.zeros((2 * C, 2, T), dtype=np.float32)
    rot_q = np.zeros(C, dtype=np.int32)
    for i, ch in enumerate(channels):
        f_rel = BASE_FREQUENCY + ch * CHANNEL_WIDTH - center_freq
        m = int(round(f_rel / 1e6))                      # integer MHz offset
        ph = -2.0 * np.pi * (f_rel / fs) * t
        kr = (taps * np.cos(ph)).astype(np.float32)
        ki = (taps * np.sin(ph)).astype(np.float32)
        kernel[2 * i + 0, 0] = kr
        kernel[2 * i + 0, 1] = -ki
        kernel[2 * i + 1, 0] = ki
        kernel[2 * i + 1, 1] = kr
        rot_q[i] = (-m * decim) % sps                    # cycles*sps per step
    demod_gain = ch_sps / (np.pi / 2.0)
    return ChannelBank(fs, center_freq, sps, decim, ch_sps, channels,
                       T, kernel, rot_q, float(demod_gain))


def _channelize_impl(x_ri, kernel, rot_q, n0: int, decim: int, sps: int):
    """x_ri (1, 2, N) float32 planes, kernel (2C, 2, T), rot_q (C,) ->
    (yr, yi), each (C, n_out) float32, n_out = (N - T) // decim + 1."""
    with fp32_matmul():
        out = torch.nn.functional.conv1d(x_ri, kernel, stride=decim)
    n_out = out.shape[-1]
    y = out[0].reshape(-1, 2, n_out)
    yr, yi = y[:, 0, :], y[:, 1, :]
    # exact modular rotator: phase_n = 2 pi * ((n0+n) * q mod sps) / sps
    n = (n0 + torch.arange(n_out, dtype=torch.int64,
                           device=x_ri.device)) % sps
    r = (n[None, :] * (rot_q.to(torch.int64)[:, None] % sps)) % sps
    ang = (2.0 * math.pi / sps) * r.to(torch.float32)
    cr, ci = torch.cos(ang), torch.sin(ang)
    return yr * cr - yi * ci, yr * ci + yi * cr


def channelize(x, bank: ChannelBank, n0: int = 0, device=None):
    """x: complex wideband samples (numpy or torch, shape (N,)).

    Returns (yr, yi) float32 tensors of shape (C, n_out) on `device`
    (the card unless the caller names another) — the decimated complex
    channel streams; n0 is the absolute index of x[0] in the stream in
    decimated output units (the count of wideband samples already
    consumed, divided by decim)."""
    device = resolve_device(device)
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    x_ri = torch.stack([x.real, x.imag]).to(device, torch.float32)[None]
    kernel = torch.from_numpy(bank.kernel).to(device)
    rot_q = torch.from_numpy(bank.rot_q).to(device)
    return _channelize_impl(x_ri, kernel, rot_q, n0, decim=bank.decim,
                            sps=bank.sps)
