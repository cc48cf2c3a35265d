"""The work of K1, the receiver front end's function from the staged
block x to the packed symbol words and the SNR partials, counted from a
cell's shapes, and the least time it takes on the card.

The byte and operation counts are a frozen copy of the port's
bench.py cost functions (pfb_snr_cost, demod_pack_cost, bound,
channelize_ops), recounted for the function as a whole: x read once,
the words and the partials written once, the channel streams y between
the two kernels not counted.
"""
from __future__ import annotations

import math

from ..reference import plain
from ..reference.plain import GROUP, GROUP_FRAMES, TF

__all__ = ["k1_work", "bound", "HBM_BPS", "FP32_OPS"]


HBM_BPS = 3.35e12          # device memory, bytes/s


FP32_OPS = 67e12           # float32 outside the tensor cores, operations/s


def bound(n_bytes: float, n_ops: float, ops_rate: float = FP32_OPS):
    """(ms, "bytes" or "operations"): the least time for n_bytes of
    device memory traffic and n_ops operations at ops_rate, the larger
    of the two."""
    tb, to = n_bytes / HBM_BPS * 1e3, n_ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def channelize_ops(C: int, M: int, Q: int) -> float:
    """Float32 operations per frame that the polyphase DFT channelizer's
    function needs: the branch FIRs (M complex outputs of Q real taps,
    4MQ) and the M-point complex DFT, as an FFT at the conventional
    5 M log2 M where that is fewer than the direct 8CM over the C
    covered bins.  The (-1)^{cn} rotator is a sign flip.  The kernels
    compute the DFT directly, as the TPU's MXU does; the bound does
    not."""
    return 4 * M * Q + min(8 * C * M, 5 * M * math.log2(M))


def pfb_snr_cost(x_numel: int, C: int, M: int, Q: int, n_frames: int):
    """pfb_snr on x of x_numel floats: x in, y (2, C, n_frames) and the
    per-tile on-energies (C, n_frames / TF) out; the channelizer's
    operations and 4 per bin for the energies."""
    G = n_frames // TF
    return (x_numel * 4 + 2 * C * n_frames * 4 + C * G * 4,
            n_frames * (channelize_ops(C, M, Q) + C * 4), FP32_OPS)


def demod_pack_cost(C: int, n_frames: int, n_groups: int, n_k: int, T: int,
                    n_words: int, n_pe: int):
    """demod_pack over C rows: the frames its n_groups timing groups
    read of the y planes in, n_words packed words and n_pe probe
    energies out.  Per row: the discriminator ~32 operations per frame
    (products 6, atan2_poly ~25, gain 1); timing 16 hypotheses x (lerp
    3, abs, sum) = 80 and slicer + pack ~4 per symbol; the probe 8 per
    tap per grid point."""
    F_read = min(n_frames, n_groups * GROUP_FRAMES + 2)
    ops = C * (F_read * 32 + n_groups * GROUP * 84 +
               n_k * T * 8)
    return 2 * C * F_read * 4 + n_words * 4 + n_pe * 4, ops, FP32_OPS


def k1_work(ref) -> dict:
    """K1's bytes and float32 operations for one block of the reference
    front end `ref`'s geometry (the program's is the same), and its
    least time (seconds) at the card's published peaks."""
    b = ref.bank
    Q, M = ref.c["h0"].shape[0], b.sps
    C = len(b.channels) + 1                       # and the probe row
    T = ref.c["probe_re"].shape[0]
    n, n_data, S, n_k, n_frames = plain.step_geometry(
        ref.block_samples, Q, b.decim, ref.n_sym, ref.slot_ch, T)
    n_t = plain.n_groups(ref.n_sym, n_k)
    x_numel = 2 * ref.block_samples
    _, ops_a, _ = pfb_snr_cost(x_numel, C, M, Q, n_frames)
    n_words = C * -(-ref.n_sym // 32)
    _, ops_b, _ = demod_pack_cost(C, n_frames, min(n_data, n_t), n_k, T,
                                  n_words, C * n_k)
    n_bytes = 4 * (x_numel + n_words + C * (n_frames // TF) + C * n_k)
    ms, kind = bound(n_bytes, ops_a + ops_b)
    return dict(bytes=n_bytes, ops=ops_a + ops_b, bound_s=ms * 1e-3,
                bound_by=kind)
