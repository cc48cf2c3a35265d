"""FIR filter design matching GNU Radio's firdes.low_pass(..., WIN_HANN).

The reference builds its channel and noise filters with
gr::filter::firdes::low_pass (lib/multi_block.cc:62-79).  We reproduce the
same design rule so filter lengths/shapes (and therefore history sizes and
detection behavior) are comparable:

  ntaps = att / (22 * transition/fs), forced odd; Hann att = 44 dB
  taps  = hann(n) * sinc(2*cutoff/fs * (n - M)) , normalized to unity DC gain
"""
from __future__ import annotations

import numpy as np

__all__ = ["ntaps_lowpass", "lowpass_taps"]

_HANN_ATTEN_DB = 44.0


def ntaps_lowpass(fs: float, transition: float) -> int:
    n = int(_HANN_ATTEN_DB / (22.0 * (transition / fs)))
    return n | 1  # odd


def lowpass_taps(gain: float, fs: float, cutoff: float,
                 transition: float) -> np.ndarray:
    n = ntaps_lowpass(fs, transition)
    m = (n - 1) // 2
    k = np.arange(n) - m
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    fwt0 = 2.0 * np.pi * cutoff / fs
    kk = np.where(k == 0, 1, k)  # avoid 0/0; k==0 lane is replaced below
    taps = np.where(k == 0, fwt0 / np.pi, np.sin(fwt0 * kk) / (np.pi * kk)) * w
    taps *= gain / taps.sum()
    return taps.astype(np.float64)
