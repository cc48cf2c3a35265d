"""The channelizer kernels' split-TF32 DFT, modelled on the CPU.

csrc/pfb_tile.cuh runs the DFT of csrc/pfb_snr.cu and
csrc/pfb_channelize.cu on the tensor cores: every operand x is split
into hi = rna(x) and lo = rna(x - hi), where rna is cvt.rna.tf32.f32
(round to nearest at mantissa bit 13, ties away from zero), and each
product is taken as hi*hi + hi*lo + lo*hi with the sums in FP32.  Here
that arithmetic is modelled in torch (the products summed in float64)
over the full-band bank and held against the plain FP32 version,
pfb_channelize_plain:

  * the three-product model within 5e-6 (a quarter of the 2e-5
    channel-stream contract) on a planted capture and on N(0, 0.5) noise;
  * the single-pass TF32 model beyond 2e-5 on the noise, which is why
    the kernels split;
  * the rounding model itself: hi has its low 13 bits zero, rounds to
    nearest with ties away from zero, and |x - hi - lo| <= 2^-22 |x|.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.ops import pfb, pfb_kernel
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

N_FRAMES = 10_000


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 for finite float32: add half a TF32 unit to the
    magnitude bits and clear the 13 bits below TF32's mantissa."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _dot(a, b):
    """a^T b in float64 over the branch axis: a (M, C), b (M, n)."""
    return a.double().T @ b.double()


def dft_model(u, dft_c, dft_s, bin_odd, passes: int):
    """The kernels' DFT of branch outputs u (2, M, n): the four
    contractions with each product in split TF32 (passes = 3) or in one
    TF32 pass (passes = 1), summed in float64, then the rotator."""
    def prod(a, b):
        if passes == 1:
            return _dot(tf32_rna(a), tf32_rna(b))
        (ah, al), (bh, bl) = split(a), split(b)
        return _dot(ah, bh) + _dot(ah, bl) + _dot(al, bh)
    yr = prod(dft_c, u[0]) + prod(dft_s, u[1])
    yi = prod(dft_c, u[1]) - prod(dft_s, u[0])
    n = u.shape[2]
    odd = (torch.arange(n) & 1).double()
    sign = 1.0 - 2.0 * (bin_odd.double()[:, None] * odd[None, :])
    return yr * sign, yi * sign


@pytest.fixture(scope="module")
def bank():
    b = pfb.make_pfb_bank(80e6, 2441e6)
    return tuple(torch.from_numpy(np.array(a, copy=True))
                 for a in (b.h0, b.h1, b.dft_c, b.dft_s, b.bin_odd))


def _planted(bank):
    """A 10,000-frame cut of a full-band planted capture, as branch rows."""
    fe = FrontEnd(80e6, 2441e6, block_slots=8, device="cpu")
    x, _ = chip_smoke.plant_capture(fe, 1, seed=3)
    D = bank[0].shape[1]
    Q = bank[0].shape[0]
    n_x = N_FRAMES + 2 * Q
    planes = torch.from_numpy(np.stack([x.real, x.imag])[:, : n_x * D]
                              .astype(np.float32))
    return pfb.deinterleave_plain(planes, D)


def _noise(bank):
    Q, D = bank[0].shape
    r = np.random.default_rng(11)
    return torch.from_numpy(r.normal(0, 0.5, (2, D, N_FRAMES + 2 * Q))
                            .astype(np.float32))


def _model_error(xp, bank, passes):
    h0, h1, dft_c, dft_s, bin_odd = bank
    yr, yi = pfb_kernel.pfb_channelize_plain(xp, *bank)
    u = pfb_kernel.branch_fir(xp, h0, h1)
    mr, mi = dft_model(u, dft_c, dft_s, bin_odd, passes)
    assert mr.shape == yr.shape == (dft_c.shape[1], N_FRAMES)
    return max((mr - yr.double()).abs().max().item(),
               (mi - yi.double()).abs().max().item())


@pytest.mark.parametrize("source", [_planted, _noise])
def test_split_tf32_dft_is_fp32_class(bank, source):
    err = _model_error(source(bank), bank, passes=3)
    assert err <= 5e-6, err


def test_single_pass_tf32_breaks_the_contract(bank):
    err = _model_error(_noise(bank), bank, passes=1)
    assert err > 2e-5, err


def _wide_floats(n=200_000, seed=5):
    """Finite float32 values over many binades, both signs, with zeros
    and the rounding ties x = hi + 2^-11 ulp among them."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal(n) * 2.0 ** r.integers(-60, 60, n)).astype(
        np.float32)
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 3 * 2 ** -12 + 2 ** -23,
                     0.0, -0.0], np.float32)
    return torch.from_numpy(np.concatenate([x, ties]))


def test_rna_clears_the_low_13_bits_and_rounds_half_away():
    x = _wide_floats()
    hi = tf32_rna(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # nearest: within half a TF32 unit of x, at x's binade
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                      torch.frexp(x.double())[1] - 11)
    assert bool(((hi.double() - x.double()).abs() <= ulp / 2).all())
    # ties go away from zero
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert tf32_rna(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]
    assert torch.equal(tf32_rna(-x), -hi)


def test_split_residual_is_within_2_pow_minus_22():
    x = _wide_floats(seed=6)
    hi, lo = split(x)
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("msps", [2, 8, 20, 80, 128])
def test_every_bank_has_the_kernels_taps_per_branch(msps):
    """The kernels fix Q at pfb_kernel.QTAPS; make_pfb_bank's prototype
    spans the same number of frames at every even rate."""
    b = pfb.make_pfb_bank(msps * 1e6, 2441e6)
    assert b.h0.shape == b.h1.shape == (pfb_kernel.QTAPS, msps // 2)
