"""[Frozen copy of gr_bluetooth_tpu_torch/ops/synth.py.]
GFSK capture synthesizer — the inverse path the reference never had.

The reference's de-facto integration tests were sample captures
(doc/README.first:39-67, samples/manifest.txt) which are stripped from the
snapshot; we synthesize equivalent wideband IQ from known packets instead,
giving golden tests with exact ground truth (SURVEY §4).

GFSK per BT spec Vol 2 Part A §3.1: BT = 0.5 Gaussian pulse shaping,
modulation index h in [0.28, 0.35] (we default 0.32); bit 1 = positive
frequency deviation (matching the reference slicer's out >= 0 -> 1,
lib/multi_block.cc:170-178).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .constants import BASE_FREQUENCY, CHANNEL_WIDTH

__all__ = ["gfsk_baseband", "PlannedPacket", "synthesize_capture"]


def _gaussian_taps(sps: int, bt: float = 0.5, span: int = 3) -> np.ndarray:
    """Gaussian frequency-pulse filter, unity DC gain."""
    t = (np.arange(span * sps + 1) - span * sps / 2) / sps
    sigma = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt)
    h = np.exp(-0.5 * (t / sigma) ** 2)
    return h / h.sum()


def gfsk_baseband(bits: np.ndarray, sps: int, bt: float = 0.5,
                  h_index: float = 0.32) -> np.ndarray:
    """Complex-baseband GFSK of a bit sequence at sps samples/symbol."""
    nrz = 2.0 * np.asarray(bits, dtype=np.float64) - 1.0
    # hold the final NRZ value through the pulse-shaping tail (a real TX
    # ramps down *after* the last bit): otherwise the last symbol's Gaussian
    # pulse is truncated at the receiver's sampling point and the final bit
    # of every burst is marginal
    rect = np.concatenate([np.repeat(nrz, sps), np.full(2 * sps, nrz[-1])])
    g = _gaussian_taps(sps, bt)
    freq = np.convolve(rect, g, mode="full")[: len(rect)]
    phase = np.cumsum(freq) * (np.pi * h_index / sps)
    return np.exp(1j * phase).astype(np.complex64)


@dataclass
class PlannedPacket:
    """One packet to place into a wideband capture."""
    channel: int              # BR channel 0..78 (freq = 2402 + ch MHz)
    start_sample: int         # position in the wideband stream
    bits: np.ndarray          # air-order symbols
    amplitude: float = 1.0
    meta: dict = field(default_factory=dict)


def synthesize_capture(packets: list[PlannedPacket], n_samples: int,
                       fs: float, center_freq: float,
                       noise_std: float = 0.01, seed: int = 0,
                       h_index: float = 0.32) -> np.ndarray:
    """Wideband complex64 IQ with the given packets + AWGN."""
    sps = int(round(fs / 1e6))
    if abs(fs - sps * 1e6) > 1e-6:
        raise ValueError("synthesizer requires integer samples/symbol")
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, noise_std, n_samples) +
         1j * rng.normal(0, noise_std, n_samples)).astype(np.complex64)
    n_idx = np.arange(n_samples, dtype=np.float64)
    for p in packets:
        f_rel = (BASE_FREQUENCY + p.channel * CHANNEL_WIDTH) - center_freq
        if abs(f_rel) > fs / 2 - CHANNEL_WIDTH / 2:
            # out of the captured bandwidth: a real front end's anti-alias
            # filter removes it; synthesizing it would alias in-band
            continue
        bb = gfsk_baseband(p.bits, sps, h_index=h_index)
        s0 = p.start_sample
        seg = slice(s0, min(s0 + len(bb), n_samples))
        m = seg.stop - seg.start
        if m <= 0:
            continue
        carrier = np.exp(2j * np.pi * f_rel / fs * n_idx[seg])
        x[seg] += (p.amplitude * bb[:m] * carrier).astype(np.complex64)
    return x
