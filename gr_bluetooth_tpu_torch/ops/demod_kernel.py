"""demod_pack: GFSK discriminator + feedforward timing + slicer + word
pack, plus the SNR probe band-pass energies, over y channel streams.

The second stage of the port's version of the TPU megakernel
gr_bluetooth_tpu/ops/pfb_kernel.py:pfb_channelize_snr_demod_fused (its
demod is gr_bluetooth_tpu/ops/demod_kernel.py:demod_timing_pack; its
probe products are pfb_kernel.py:494-506).  The first stage is
ops/pfb_kernel.py:pfb_snr.

Per 512-symbol group t and channel row c, over frames 1024t + l of the
row (frames past the stream read as zero):

    d[l]     = gain * atan2_poly(Im, Re)(y[l+1] conj(y[l]))
    metric_p = sum_{s < nvalid} |d[2s+par](1-f) + d[2s+par+1] f|,
               f = (p % 8) / 8, par = p // 8       (16 hypotheses)
    best     = first maximum (earliest on ties)
    bit_s    = d[2s+par*](1-f*) + d[2s+par*+1] f* >= 0

bit s of word j is symbol 32j + s; groups t >= n_data_groups give
all-ones words (the TPU kernel's tiles past the data); bits of symbols
>= n_sym are zero.  Probe: pe[c, k] = |sum_l y[c, 40k + l] tap[l]|^2 on
the global 40-frame grid, k < n_k (zero in groups past the data).

CUDA kernel: csrc/demod_pack.cu.  The plain PyTorch version below runs
for CPU tensors and is the kernel's yardstick on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from ..utils.device import fp32_matmul
from .detect_kernel import pack_bits_words

__all__ = ["atan2_poly", "demod_pack", "demod_pack_plain", "n_groups",
           "GROUP", "PROBE_STRIDE"]

GROUP = 512                    # symbols per timing group
GROUP_FRAMES = 2 * GROUP       # frames per group (2 samples/symbol)
NPH = 16                       # timing hypotheses
PROBE_STRIDE = 40              # probe grid, channel-rate frames


def atan2_poly(y, x):
    """Branch-free float32 atan2: octant reduction + the Cephes atanf
    minimax polynomial, operation for operation the JAX package's
    ops/demod_kernel.py:atan2_poly (so the slicer's bits match it)."""
    ax, ay = x.abs(), y.abs()
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    q = num / torch.where(den == 0.0, torch.ones_like(den), den)
    big = q > 0.4142135624                             # tan(pi/8)
    t = torch.where(big, (q - 1.0) / (q + 1.0), q)
    z = t * t
    p = ((((8.05374449538e-2 * z - 1.38776856032e-1) * z
           + 1.99777106478e-1) * z - 3.33329491539e-1) * z * t + t)
    r = torch.where(big, 0.78539816339744831 + p, p)   # atan(q)
    r = torch.where(swap, 1.5707963267948966 - r, r)   # atan(ay/ax)
    r = torch.where(x < 0.0, 3.14159265358979 - r, r)
    return torch.where(y < 0.0, -r, r)


def n_groups(n_sym: int, n_k: int) -> int:
    """Groups a demod_pack launch covers: every symbol and every probe
    grid point k < n_k."""
    g = -(-n_sym // GROUP)
    if n_k > 0:
        g = max(g, PROBE_STRIDE * (n_k - 1) // GROUP_FRAMES + 1)
    return g


def _zero_extend(y, width: int):
    if y.shape[1] >= width:
        return y[:, :width]
    return torch.nn.functional.pad(y, (0, width - y.shape[1]))


def demod_pack_plain(yr, yi, gain: float, n_sym: int, taps_re, taps_im,
                     n_k: int, n_data_groups: int | None = None):
    """Plain PyTorch version of demod_pack (same arguments and results);
    its probe products are FP32 matmuls whatever the caller's TF32
    setting."""
    C, F = yr.shape
    dev = yr.device
    n_t = n_groups(n_sym, n_k)
    if n_data_groups is None:
        n_data_groups = -(-F // GROUP_FRAMES)
    T = taps_re.shape[0]
    width = max(n_t * GROUP_FRAMES + 2, PROBE_STRIDE * max(n_k - 1, 0) + T)
    wr, wi = _zero_extend(yr, width), _zero_extend(yi, width)

    Wr = wr.unfold(1, GROUP_FRAMES + 2, GROUP_FRAMES)[:, :n_t]
    Wi = wi.unfold(1, GROUP_FRAMES + 2, GROUP_FRAMES)[:, :n_t]
    pr = Wr[..., 1:] * Wr[..., :-1] + Wi[..., 1:] * Wi[..., :-1]
    pim = Wi[..., 1:] * Wr[..., :-1] - Wr[..., 1:] * Wi[..., :-1]
    d = gain * atan2_poly(pim, pr)                     # (C, n_t, 1025)
    de = d[..., 0:GROUP_FRAMES:2]                      # d[2s]
    dd = d[..., 1:GROUP_FRAMES:2]                      # d[2s+1]
    de1 = d[..., 2:GROUP_FRAMES + 1:2]                 # d[2s+2]

    t = torch.arange(n_t, device=dev)
    nvalid = (n_sym - GROUP * t).clamp(0, GROUP)
    valid = torch.arange(GROUP, device=dev)[None, :] < nvalid[:, None]
    cols = []
    for a, b in ((de, dd), (dd, de1)):
        for p8 in range(8):
            u = (a * (1.0 - p8 / 8.0) + b * (p8 / 8.0)).abs()
            cols.append(torch.where(valid, u, 0.0).sum(-1))
    best = torch.stack(cols, -1).argmax(-1, keepdim=True)  # (C, n_t, 1)
    fb = (best % 8).to(torch.float32) / 8.0
    soft = torch.where(best >= 8, dd * (1.0 - fb) + de1 * fb,
                       de * (1.0 - fb) + dd * fb)
    bits = (soft >= 0) | (t >= n_data_groups)[None, :, None]
    bits = bits.reshape(C, n_t * GROUP)
    sym = torch.arange(n_t * GROUP, device=dev)
    bits = bits & (sym < n_sym)[None, :]
    words = pack_bits_words(bits)[:, : -(-n_sym // 32)]

    P_r = wr[:, : PROBE_STRIDE * (n_k - 1) + T].unfold(1, T, PROBE_STRIDE)
    P_i = wi[:, : PROBE_STRIDE * (n_k - 1) + T].unfold(1, T, PROBE_STRIDE)
    with fp32_matmul():
        rr, ri = P_r @ taps_re, P_r @ taps_im
        ir, ii = P_i @ taps_re, P_i @ taps_im
    pe = (rr - ii) ** 2 + (ri + ir) ** 2               # (C, n_k)
    k_group = PROBE_STRIDE * torch.arange(n_k, device=dev) // GROUP_FRAMES
    pe = torch.where((k_group < n_data_groups)[None, :], pe, 0.0)
    return words.contiguous(), pe.contiguous()


def _launcher():
    fn = cuda_build.load("demod_pack").demod_pack_launch
    if fn.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, I, I, Fl, I, I, I, P, P, I, I, P, I, P, P]
        fn.restype = ctypes.c_int
    return fn


def demod_pack(yr, yi, gain: float, n_sym: int, taps_re, taps_im,
               n_k: int, n_data_groups: int | None = None):
    """yr, yi (C, F) float32 channel streams -> (words, pe):
    words (C, ceil(n_sym/32)) int32 packed symbols, pe (C, n_k) float32
    probe energies.  n_data_groups defaults to the groups that start
    inside the stream.  A CPU tensor runs the plain version; a CUDA
    tensor launches csrc/demod_pack.cu (counted in demod_pack.launches),
    whose launcher refuses a probe longer than its TMAX taps (every
    bank's probe has 201, ops/snr.py)."""
    for name, t in (("yr", yr), ("yi", yi), ("taps_re", taps_re),
                    ("taps_im", taps_im)):
        if t.dtype != torch.float32 or t.device != yr.device:
            raise TypeError(f"demod_pack: {name} must be float32 on "
                            f"{yr.device}")
    if yr.ndim != 2 or yi.shape != yr.shape:
        raise ValueError("demod_pack: yr/yi must be equal (C, F) streams")
    if n_sym <= 0 or n_k <= 0 or taps_im.shape != taps_re.shape:
        raise ValueError("demod_pack: need n_sym > 0, n_k > 0 and equal "
                         "probe taps")
    if yr.device.type == "cpu":
        return demod_pack_plain(yr, yi, gain, n_sym, taps_re, taps_im, n_k,
                                n_data_groups)
    if yr.device.type != "cuda":
        raise ValueError(f"demod_pack: unsupported device {yr.device}")
    C, F = yr.shape
    if n_data_groups is None:
        n_data_groups = -(-F // GROUP_FRAMES)
    yr, yi, taps_re, taps_im = (t.contiguous()
                                for t in (yr, yi, taps_re, taps_im))
    nw = -(-n_sym // 32)
    words = torch.empty((C, nw), dtype=torch.int32, device=yr.device)
    pe = torch.empty((C, n_k), dtype=torch.float32, device=yr.device)
    with torch.cuda.device(yr.device):
        stream = torch.cuda.current_stream(yr.device).cuda_stream
        rc = _launcher()(yr.data_ptr(), yi.data_ptr(), C, F, float(gain),
                         n_sym, n_groups(n_sym, n_k), n_data_groups,
                         taps_re.data_ptr(), taps_im.data_ptr(),
                         taps_re.shape[0], n_k, words.data_ptr(), nw,
                         pe.data_ptr(), stream)
    cuda_build.check(rc, "demod_pack")
    demod_pack.launches += 1
    return words, pe


demod_pack.launches = 0
