"""GFSK quadrature demod + feedforward timing recovery + slicer.

The flat chain's demodulator: the port of gr_bluetooth_tpu/ops/demod.py,
torch code as the JAX package's is XLA code (the fused chain's
counterpart is the CUDA kernel ops/demod_kernel.py:demod_pack).

  1. demod d[n] = gain * atan2(Im, Re)(y[n] conj(y[n-1]))
  2. hypothesize P timing phases tau in [0, ch_sps); sample the demod
     stream at k*ch_sps + tau by linear interpolation
  3. per channel and per group of symbols pick the phase with the largest
     sum of |d| (the GFSK eye is open widest there; first maximum on ties)
  4. slice the winning phase: bit_k = d(k*ch_sps + tau*) >= 0

The discriminator is torch.atan2, as the JAX chain uses jnp.arctan2; the
fused chain's atan2_poly differs from it by less than 2e-6.
"""
from __future__ import annotations

import torch

__all__ = ["quadrature_demod", "recover_symbols", "demod_and_slice"]


def quadrature_demod(yr, yi, gain: float):
    """d[n] = gain * arg(y[n] * conj(y[n-1])); shape (C, N) -> (C, N-1)."""
    pr = yr[:, 1:] * yr[:, :-1] + yi[:, 1:] * yi[:, :-1]
    pi = yi[:, 1:] * yr[:, :-1] - yr[:, 1:] * yi[:, :-1]
    return gain * torch.atan2(pi, pr)


def recover_symbols(d, ch_sps: float, n_sym: int, n_phases: int = 16,
                    group: int = 512):
    """Feedforward timing recovery over a demodulated block.

    d: (C, N) float32.  Returns (soft, bits): (C, n_sym) float32 soft
    symbol values at the per-(channel, group) best timing phase, and int8
    bits.  At exactly 2 samples/symbol (the PFB path) the strided form
    runs; other rates take the gather form."""
    if ch_sps == 2.0:
        return _recover_symbols_sps2(d, n_sym, n_phases=n_phases,
                                     group=group)
    C, N = d.shape
    dev = d.device
    taus = (torch.arange(n_phases, dtype=torch.float32, device=dev)
            / n_phases) * ch_sps
    base = torch.arange(n_sym, dtype=torch.float32, device=dev) * ch_sps
    pos = base[None, :] + taus[:, None]                          # (P, K)
    i0 = torch.floor(pos).to(torch.int64).clamp(0, N - 2)
    frac = pos - i0.to(torch.float32)
    v = d[:, i0] * (1.0 - frac)[None] + d[:, i0 + 1] * frac[None]
    n_groups = (n_sym + group - 1) // group
    pad = n_groups * group - n_sym
    vp = torch.nn.functional.pad(v.abs(), (0, pad))
    metric = vp.reshape(C, n_phases, n_groups, group).sum(-1)    # (C, P, G)
    best = metric.argmax(1)                                      # (C, G)
    sel = best.repeat_interleave(group, -1)[:, :n_sym]           # (C, K)
    soft = torch.take_along_dim(v, sel[:, None, :], 1)[:, 0, :]
    return soft, (soft >= 0).to(torch.int8)


def _recover_symbols_sps2(d, n_sym: int, n_phases: int = 16,
                          group: int = 512):
    """Strided timing recovery at exactly 2 samples/symbol: phase
    tau = p/8 interpolates between two of the three strided views d[2k],
    d[2k+1], d[2k+2] with a fixed fraction."""
    C, N = d.shape
    K = n_sym
    e0 = d[:, 0: 2 * K: 2]
    o0 = d[:, 1: 2 * K + 1: 2]
    e1 = d[:, 2: 2 * K + 2: 2]
    # truncated tails (N may fall one short of 2K+2) read as zero
    if o0.shape[1] < K:
        o0 = torch.nn.functional.pad(o0, (0, K - o0.shape[1]))
    if e1.shape[1] < K:
        e1 = torch.nn.functional.pad(e1, (0, K - e1.shape[1]))

    half = n_phases // 2
    n_groups = (n_sym + group - 1) // group
    pad = n_groups * group - K
    metrics = []
    for p in range(n_phases):
        f = (p % half) / float(half)
        a, bb = (e0, o0) if p < half else (o0, e1)
        m = torch.nn.functional.pad((a * (1.0 - f) + bb * f).abs(), (0, pad))
        metrics.append(m.reshape(C, n_groups, group).sum(-1))  # (C, G)
    best = torch.stack(metrics, 1).argmax(1)                   # (C, G)

    fK = ((best % half).to(torch.float32) / half).repeat_interleave(
        group, -1)[:, :K]
    m1 = (best >= half).repeat_interleave(group, -1)[:, :K]
    a = torch.where(m1, o0, e0)
    bb = torch.where(m1, e1, o0)
    soft = a * (1.0 - fK) + bb * fK
    return soft, (soft >= 0).to(torch.int8)


def demod_and_slice(yr, yi, gain: float, ch_sps: float, n_sym: int,
                    n_phases: int = 16, group: int = 512):
    d = quadrature_demod(yr, yi, gain)
    return recover_symbols(d, ch_sps, n_sym, n_phases=n_phases, group=group)
