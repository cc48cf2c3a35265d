"""Rational (L/M polyphase) resampler for arbitrary input rates.

The reference accepts any SDR rate >= 2 Msps (decim = floor(sps/2),
lib/multi_block.cc:82; apps/btrx:66-78 passes the radio rate straight
through).  Our filterbanks want an integer (PFB: even) number of samples
per symbol, so off-grid rates (2.5 Msps, 7.68 Msps, ...) are first
resampled to the nearest even integer Msps >= fs with a polyphase
upsampler — the band content is preserved (cutoff at the input Nyquist),
every downstream stage then runs its fast integer-rate path, and slot /
clkn attribution is untouched (resampling is time-invariant).

Host-side numpy: at the odd rates in question (< 8 Msps) the resample is
a trivial fraction of the host budget; captures at production rates are
integer-Msps and never enter this path.

The port of gr_bluetooth_tpu/ops/resample.py, the same NumPy code, so
its outputs are bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np

from .filters import lowpass_taps

__all__ = ["Resampler", "make_resampler", "pick_internal_rate"]


def pick_internal_rate(fs: float) -> float:
    """Nearest even integer Msps >= fs (the PFB's fast path)."""
    return 2e6 * max(1, int(np.ceil(fs / 2e6)))


@dataclass
class Resampler:
    fs_in: float
    fs_out: float
    L: int
    M: int
    taps: np.ndarray              # prototype, length Q*L, gain L
    Q: int
    _tail: np.ndarray = field(default=None, repr=False)
    _g0: int = 0                  # global input index of _tail[:, 0]
    _j: int = 0                   # next output index (global)

    def __post_init__(self):
        self.reset()

    def reset(self):
        # zero pre-history so output 0's window is defined (adds the
        # usual (Q-1)/2-sample filter delay, ~10 us at these rates)
        self._tail = np.zeros((2, self.Q - 1), np.float32)
        self._g0 = -(self.Q - 1)
        self._j = 0

    def push(self, x: np.ndarray) -> np.ndarray:
        """Streaming resample of (2, N) float32 planes; keeps filter
        history and the L-phase position across calls, so chunked and
        one-shot outputs are bit-identical.

        Output j (global) = sum_q taps[(j*M)%L + L*q] * x[(j*M)//L - q].
        """
        x = np.asarray(x, np.float32)
        buf = np.concatenate([self._tail, x], axis=1)
        g0 = self._g0
        E = g0 + buf.shape[1] - 1           # last available input index
        j_hi = (E * self.L + self.L - 1) // self.M   # max j: b_j <= E
        n_out = max(0, j_hi + 1 - self._j)
        y = np.zeros((2, n_out), np.float32)
        for c in range(self.L):
            first = self._j + ((c - self._j) % self.L)
            if first >= self._j + n_out:
                continue
            js = np.arange(first, self._j + n_out, self.L)
            p = (first * self.M) % self.L
            tc = self.taps[p::self.L][: self.Q]
            b0 = (first * self.M) // self.L - g0     # buf coords, >= Q-1
            for plane in range(2):
                full = np.convolve(buf[plane], tc, mode="full")
                y[plane, js - self._j] = \
                    full[b0: b0 + js.size * self.M: self.M]
        self._j += n_out
        keep_from = max(0, (self._j * self.M) // self.L - (self.Q - 1) - g0)
        self._tail = buf[:, keep_from:]
        self._g0 = g0 + keep_from
        return y

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """One-shot resample (resets state before and after)."""
        self.reset()
        y = self.push(x)
        self.reset()
        return y


def make_resampler(fs_in: float, fs_out: float) -> Resampler:
    frac = Fraction(fs_out / fs_in).limit_denominator(1000)
    L, M = frac.numerator, frac.denominator
    if abs(fs_in * L / M - fs_out) > 1e-3:
        raise ValueError(f"rate ratio {fs_out}/{fs_in} is not a small "
                         f"rational")
    cutoff = 0.45 * min(fs_in, fs_out)
    trans = 0.1 * min(fs_in, fs_out)
    taps = lowpass_taps(L, L * fs_in, cutoff, trans).astype(np.float32)
    Q = -(-len(taps) // L)
    taps = np.pad(taps, (0, Q * L - len(taps)))
    return Resampler(fs_in, fs_out, L, M, taps, Q)
