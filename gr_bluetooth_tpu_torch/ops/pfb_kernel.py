"""The polyphase DFT channelizer kernels.

pfb_snr (channelizer + per-tile on-channel energies over flat planes) is
the first stage of the port's version of the TPU megakernel
gr_bluetooth_tpu/ops/pfb_kernel.py:pfb_channelize_snr_demod_fused; its
second stage is ops/demod_kernel.py:demod_pack.  The TPU fuses both to
keep the y streams out of HBM; here y makes one round trip through
device memory (about 110 MB per full-band block, some 33 us on an
H100), which leaves each kernel small enough for shared memory.

Frame j of the output covers input samples [jD, jD + 2QD) of the flat
(2, N) planes; samples past n_x * D (n_x = N // D) read as zero, as the
TPU's staged layout holds them, so frames past the data match it.

pfb_channelize (channelizer only, over ops/pfb.py:deinterleave's
(2, D, n_x) branch rows) replaces the TPU kernel
gr_bluetooth_tpu/ops/pfb_kernel.py:pfb_channelize_fused in its flat-input
mode: (C, n) streams with n = n_x - 2Q, the output of
gr_bluetooth_tpu/ops/pfb.py:_pfb_impl for flat planes.

CUDA kernels: csrc/pfb_snr.cu and csrc/pfb_channelize.cu, which share
their body (csrc/pfb_tile.cuh): persistent blocks, the branch FIRs on
the CUDA cores and the DFT on the tensor cores in split TF32 (three
passes, FP32-class accuracy); see the sources' notes for the bounds.
The plain PyTorch versions below compute the same functions in FP32 and
run for tensors on the CPU; they are also the kernels' yardsticks on the
card.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from ..utils.device import fp32_matmul

__all__ = ["QTAPS", "TF", "branch_fir", "pfb_channelize",
           "pfb_channelize_plain", "pfb_snr", "pfb_snr_plain"]

TF = 50            # frames per tile (csrc/pfb_snr.cu TF); divides slot_ch
QTAPS = 7          # the kernels' taps per branch (csrc/pfb_tile.cuh QTAPS)


def _check_bank(what, x, h0, h1, dft_c, dft_s, bin_odd):
    for name, t in (("x", x), ("h0", h0), ("h1", h1), ("dft_c", dft_c),
                    ("dft_s", dft_s), ("bin_odd", bin_odd)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
    Q, D = h0.shape
    if h1.shape != (Q, D) or dft_c.shape[0] != 2 * D or \
            dft_s.shape != dft_c.shape or bin_odd.shape != dft_c.shape[1:]:
        raise ValueError(f"{what}: inconsistent bank shapes")
    if x.device.type == "cuda" and Q != QTAPS:
        # every bank that ops/pfb.py:make_pfb_bank builds has Q = 7; the
        # plain versions take any Q
        raise ValueError(f"{what}: the CUDA kernel takes banks of {QTAPS} "
                         f"taps per branch, got {Q}")


def _check(x, h0, h1, dft_c, dft_s, bin_odd, n_frames):
    _check_bank("pfb_snr", x, h0, h1, dft_c, dft_s, bin_odd)
    if x.ndim != 2 or x.shape[0] != 2:
        raise ValueError(f"pfb_snr: x must be (2, N), got {tuple(x.shape)}")
    if n_frames <= 0 or n_frames % TF:
        raise ValueError(f"pfb_snr: n_frames must be a positive multiple of "
                         f"{TF}, got {n_frames}")


def pfb_snr_plain(x, h0, h1, dft_c, dft_s, bin_odd, n_frames: int):
    """Plain PyTorch version of pfb_snr (same arguments and results):
    pfb_channelize_plain over the branch rows of the flat planes, zero
    frames past the data, then the per-tile energies."""
    Q, D = h0.shape
    n_x = x.shape[1] // D
    xp = x[:, : n_x * D].reshape(2, n_x, D).transpose(1, 2)
    # n_frames outputs read n_frames + 2Q - 1 input frames
    xp = torch.nn.functional.pad(xp, (0, max(0, n_frames + 2 * Q - n_x)))
    yr, yi = pfb_channelize_plain(xp[:, :, : n_frames + 2 * Q], h0, h1,
                                  dft_c, dft_s, bin_odd)
    C = yr.shape[0]
    oe = (yr * yr + yi * yi).reshape(C, n_frames // TF, TF).sum(-1)
    return yr, yi, oe


def _launcher():
    lib = cuda_build.load("pfb_snr")
    fn = lib.pfb_snr_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, L, L, P, P, P, P, P, I, I, I, I, P, P, P, P]
        fn.restype = ctypes.c_int
        if lib.pfb_snr_tile_frames() != TF:
            raise RuntimeError("csrc/pfb_snr.cu TF differs from "
                               "ops/pfb_kernel.TF")
    return fn


def pfb_snr(x, h0, h1, dft_c, dft_s, bin_odd, n_frames: int):
    """Channelize one block: x (2, N) float32 planes, bank constants
    h0/h1 (Q, D), dft_c/dft_s (M, C), bin_odd (C,).

    Returns yr, yi (C, n_frames) float32 channel streams and oe
    (C, n_frames // TF) float32 on-energy sums per TF-frame tile.
    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/pfb_snr.cu (and counts it in pfb_snr.launches)."""
    _check(x, h0, h1, dft_c, dft_s, bin_odd, n_frames)
    if x.device.type == "cpu":
        return pfb_snr_plain(x, h0, h1, dft_c, dft_s, bin_odd, n_frames)
    if x.device.type != "cuda":
        raise ValueError(f"pfb_snr: unsupported device {x.device}")
    Q, D = h0.shape
    C = dft_c.shape[1]
    x, h0, h1, dft_c, dft_s, bin_odd = (
        t.contiguous() for t in (x, h0, h1, dft_c, dft_s, bin_odd))
    yr = torch.empty((C, n_frames), dtype=torch.float32, device=x.device)
    yi = torch.empty_like(yr)
    oe = torch.empty((C, n_frames // TF), dtype=torch.float32,
                     device=x.device)
    n_x = x.shape[1] // D
    # the launch and its stream on the tensors' device, whichever device
    # is the host thread's current one
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _launcher()(x.data_ptr(), n_x * D, x.shape[1], h0.data_ptr(),
                         h1.data_ptr(), dft_c.data_ptr(), dft_s.data_ptr(),
                         bin_odd.data_ptr(), Q, D, C, n_frames,
                         yr.data_ptr(), yi.data_ptr(), oe.data_ptr(), stream)
    cuda_build.check(rc, "pfb_snr")
    pfb_snr.launches += 1
    return yr, yi, oe


pfb_snr.launches = 0


def branch_fir(xp, h0, h1):
    """The branch FIRs of pfb_channelize_plain: (2, D, n_x) branch rows ->
    u (2, M, n), n = n_x - 2Q; branch d < D takes h0 at frame offsets
    2q, branch D + d takes h1 at offsets 2q + 1."""
    Q, D = h0.shape
    n = xp.shape[2] - 2 * Q
    v0 = torch.zeros((2, D, n), dtype=torch.float32, device=xp.device)
    v1 = torch.zeros_like(v0)
    for q in range(Q):
        v0 = v0 + xp[:, :, 2 * q: 2 * q + n] * h0[q][None, :, None]
        v1 = v1 + xp[:, :, 2 * q + 1: 2 * q + 1 + n] * h1[q][None, :, None]
    return torch.cat([v0, v1], dim=1)


def pfb_channelize_plain(xp, h0, h1, dft_c, dft_s, bin_odd):
    """Plain PyTorch version of pfb_channelize (same arguments and
    results): gr_bluetooth_tpu/ops/pfb.py:_pfb_impl's flat formulation,
    Q shifted multiply-adds along frames, then the DFT as FP32 matmuls
    (whatever the caller's TF32 setting)."""
    n = xp.shape[2] - 2 * h0.shape[0]
    u = branch_fir(xp, h0, h1)                         # (2, M, n)
    with fp32_matmul():
        yr = dft_c.T @ u[0] + dft_s.T @ u[1]           # (C, n)
        yi = dft_c.T @ u[1] - dft_s.T @ u[0]
    odd = (torch.arange(n, device=xp.device) & 1).to(torch.float32)
    sign = 1.0 - 2.0 * (bin_odd[:, None] * odd[None, :])
    return (yr * sign).contiguous(), (yi * sign).contiguous()


def _channelize_launcher():
    fn = cuda_build.load("pfb_channelize").pfb_channelize_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, P, P, P, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def pfb_channelize(xp, h0, h1, dft_c, dft_s, bin_odd):
    """Channelize deinterleaved planes: xp (2, D, n_x) float32 branch rows
    (ops/pfb.py:deinterleave), bank constants h0/h1 (Q, D), dft_c/dft_s
    (M, C), bin_odd (C,).

    Returns yr, yi (C, n) float32 channel streams, n = n_x - 2Q.  A CPU
    tensor runs the plain version; a CUDA tensor launches
    csrc/pfb_channelize.cu (and counts it in pfb_channelize.launches)."""
    _check_bank("pfb_channelize", xp, h0, h1, dft_c, dft_s, bin_odd)
    Q, D = h0.shape
    if xp.ndim != 3 or xp.shape[:2] != (2, D) or xp.shape[2] <= 2 * Q:
        raise ValueError(f"pfb_channelize: xp must be (2, {D}, n_x) with "
                         f"n_x > {2 * Q}, got {tuple(xp.shape)}")
    if xp.device.type == "cpu":
        return pfb_channelize_plain(xp, h0, h1, dft_c, dft_s, bin_odd)
    if xp.device.type != "cuda":
        raise ValueError(f"pfb_channelize: unsupported device {xp.device}")
    C = dft_c.shape[1]
    n_x = xp.shape[2]
    xp, h0, h1, dft_c, dft_s, bin_odd = (
        t.contiguous() for t in (xp, h0, h1, dft_c, dft_s, bin_odd))
    yr = torch.empty((C, n_x - 2 * Q), dtype=torch.float32, device=xp.device)
    yi = torch.empty_like(yr)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = _channelize_launcher()(xp.data_ptr(), n_x, h0.data_ptr(),
                                    h1.data_ptr(), dft_c.data_ptr(),
                                    dft_s.data_ptr(), bin_odd.data_ptr(), Q,
                                    D, C, yr.data_ptr(), yi.data_ptr(),
                                    stream)
    cuda_build.check(rc, "pfb_channelize")
    pfb_channelize.launches += 1
    return yr, yi


pfb_channelize.launches = 0
