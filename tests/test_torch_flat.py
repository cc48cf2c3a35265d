"""The port's flat chain (FrontEnd.device_step, stream_sync) against the
JAX package.

  * deinterleave_plain vs pfb._deinterleave (K6's function): exact;
  * pfb_channelize_plain over deinterleave_plain vs the Pallas kernel K5,
    pfb_kernel.pfb_channelize_fused, in interpret mode: within 2e-5
    across tile edges and a ragged tail; and the public pfb_channelize
    vs JAX pfb.pfb_channelize;
  * stream_snr vs _stream_snr_impl: within 1e-3 dB;
  * quadrature_demod + recover_symbols, the 2-samples/symbol form and
    the general gather form: soft symbols within 1e-5, bits equal except
    where |soft| < 1e-5 (the discriminators are torch.atan2 and
    jnp.arctan2);
  * the flat device_step vs the JAX step on flat planes (use_pallas, its
    detector in interpret mode): identical counts and hit tables,
    windows equal but for at most one symbol per 10^5, SNR within
    1e-3 dB.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from gr_bluetooth_tpu.ops import demod as jdemod
from gr_bluetooth_tpu.ops import pfb as jpfb
from gr_bluetooth_tpu.ops import pfb_kernel as jpfb_kernel
from gr_bluetooth_tpu.ops import snr as jsnr
from gr_bluetooth_tpu_torch.ops import demod, pfb, pfb_kernel, snr
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def bank():
    return pfb.make_pfb_bank(8e6, 2441e6)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bank_t(b):
    return tuple(_t(a) for a in (b.h0, b.h1, b.dft_c, b.dft_s, b.bin_odd))


def _bank_j(b):
    return tuple(jnp.asarray(a) for a in (b.h0, b.h1, b.dft_c, b.dft_s,
                                          b.bin_odd))


@pytest.mark.parametrize("D,N", [(4, 4 * 1000), (40, 40 * 77 + 13),
                                 (3, 31)])
def test_deinterleave_plain_matches_jax(D, N):
    x = np.random.default_rng(N).normal(size=(2, N)).astype(np.float32)
    n_x = N // D
    ref = np.asarray(jpfb._deinterleave(jnp.asarray(x[:, : n_x * D]), D))
    got = pfb.deinterleave(_t(x), D)
    assert got.shape == (2, D, n_x) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(pfb.deinterleave_plain(_t(x), D).numpy(), ref)


@pytest.mark.parametrize("n_frames,tail", [(50, 0), (1024, 0), (1500, 0),
                                           (2048, 0), (2100, 0), (1030, 3)])
def test_pfb_channelize_plain_matches_k5(bank, n_frames, tail):
    """K5 in interpret mode, flat input, across its 1024-frame tiles and
    below one tile; `tail` samples past the last whole frame are
    ignored."""
    rng = np.random.default_rng(n_frames + tail)
    Q, D = bank.h0.shape
    x = rng.standard_normal((2, (n_frames + 2 * Q) * D + tail)).astype(
        np.float32)
    yr_j, yi_j = (np.asarray(a) for a in jpfb_kernel.pfb_channelize_fused(
        jnp.asarray(x), *_bank_j(bank), D, interpret=True))
    xp = pfb.deinterleave_plain(_t(x), D)
    yr, yi = pfb_kernel.pfb_channelize(xp, *_bank_t(bank))
    assert yr.shape == yi.shape == yr_j.shape == (bank.n_channels + 1,
                                                  n_frames)
    np.testing.assert_allclose(yr.numpy(), yr_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(yi.numpy(), yi_j, rtol=0, atol=2e-5)


def test_public_pfb_channelize_matches_jax(bank):
    x = tp.planted(8e6, 12, seed=2)
    yr_j, yi_j = (np.asarray(a) for a in jpfb.pfb_channelize(x, bank))
    yr, yi = pfb.pfb_channelize(x, bank)
    assert yr.device.type == "cpu" and yr.shape == yr_j.shape
    np.testing.assert_allclose(yr.numpy(), yr_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(yi.numpy(), yi_j, rtol=0, atol=2e-5)
    # complex input, a tensor in, the same streams out
    yr_c, _ = pfb.pfb_channelize(torch.complex(_t(x[0]), _t(x[1])), bank)
    assert torch.equal(yr_c, yr)


@pytest.mark.parametrize("fs,n_slots", [(4e6, 13), (8e6, 21)])
def test_stream_snr_matches_jax(fs, n_slots):
    b = pfb.make_pfb_bank(fs, 2441e6)
    sc = snr.make_stream_snr_consts(b)
    yr_j, yi_j = jpfb.pfb_channelize(tp.planted(fs, n_slots, seed=4), b)
    ref = [np.asarray(a) for a in jsnr._stream_snr_impl(
        yr_j, yi_j, jnp.asarray(sc.taps_re), jnp.asarray(sc.taps_im),
        slot_ch=sc.slot_ch, kappa=sc.kappa)]
    got = [a.numpy() for a in snr.stream_snr(
        _t(yr_j), _t(yi_j), _t(sc.taps_re), _t(sc.taps_im),
        slot_ch=sc.slot_ch, kappa=sc.kappa)]
    assert got[0].shape == ref[0].shape == (n_slots * 625 * 2 // sc.slot_ch
                                            - 1, b.n_channels)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=0)


@pytest.mark.parametrize("allow", [True, False])
def test_stream_snr_keeps_the_callers_tf32_flag(allow):
    """The probe contraction turns TF32 off for itself only."""
    b = pfb.make_pfb_bank(4e6, 2441e6)
    sc = snr.make_stream_snr_consts(b)
    y = torch.ones((b.n_channels + 1, 2 * sc.slot_ch))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        snr.stream_snr(y, y, _t(sc.taps_re), _t(sc.taps_im),
                       slot_ch=sc.slot_ch, kappa=sc.kappa)
        assert torch.backends.cuda.matmul.allow_tf32 is allow
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _assert_symbols_agree(got, ref):
    (soft, bits), (soft_j, bits_j) = got, ref
    soft_j, bits_j = np.asarray(soft_j), np.asarray(bits_j)
    assert bits.dtype == torch.int8 and bits.shape == bits_j.shape
    np.testing.assert_allclose(soft.numpy(), soft_j, rtol=0, atol=1e-5)
    differ = bits.numpy() != bits_j
    assert (np.abs(soft_j[differ]) < 1e-5).all()


@pytest.mark.parametrize("ch_sps", [2.0, 2.5, 3.0])
def test_demod_matches_jax(ch_sps):
    """The discriminator and both timing forms on GFSK-like streams
    with noise (the general form runs at 2.5 and 3 samples/symbol)."""
    r = np.random.default_rng(int(ch_sps * 10))
    C, n_sym = 5, 1500
    F = int(n_sym * ch_sps) + 3
    ph = np.cumsum(r.normal(0, 0.8, (C, F)), axis=1)
    y = np.exp(1j * ph) + 0.05 * (r.normal(size=(C, F)) +
                                  1j * r.normal(size=(C, F)))
    yr, yi = y.real.astype(np.float32), y.imag.astype(np.float32)
    gain = 2.0 / (np.pi / 2.0)
    d_j = jdemod.quadrature_demod(jnp.asarray(yr), jnp.asarray(yi), gain)
    d = demod.quadrature_demod(_t(yr), _t(yi), gain)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-5)
    _assert_symbols_agree(demod.recover_symbols(d, ch_sps, n_sym),
                          jdemod.recover_symbols(d_j, ch_sps, n_sym))
    _assert_symbols_agree(demod.demod_and_slice(_t(yr), _t(yi), gain,
                                                ch_sps, n_sym),
                          jdemod.demod_and_slice(jnp.asarray(yr),
                                                 jnp.asarray(yi), gain,
                                                 ch_sps, n_sym))


def _compare_flat_steps(fj, ft, x):
    """Every block through the JAX step on flat planes and the port's
    flat device_step; returns the JAX hit count."""
    total = 0
    for xb in tp.blocks(fj, x):
        oj = [None if o is None else np.asarray(o)
              for o in fj._jit_step(jnp.asarray(xb))]
        ot = ft.device_step(xb)
        assert oj[4:] == [None, None, None] and ot[4:] == (None, None, None)
        snr_t = ot[0].numpy()
        assert snr_t.dtype == np.float32 and snr_t.shape == oj[0].shape
        np.testing.assert_allclose(snr_t, oj[0], atol=1e-3, rtol=0)
        assert int(ot[1]) == int(oj[1])
        assert np.array_equal(ot[2].numpy(), oj[2])
        tp.assert_windows_agree(ot[3].numpy(), oj[3])
        total += int(oj[1])
    return total


@pytest.mark.parametrize("fs", [4e6, 8e6])
def test_flat_step_matches_jax_on_piconet_golden(fs):
    fj, ft = tp.pair(fs, max_ac_errors=1)
    with tp.pallas_interpret():
        assert _compare_flat_steps(fj, ft, tp.piconet(fs, n_blocks=2)) > 0


@pytest.mark.parametrize("fs", [4e6, 8e6])
def test_flat_step_matches_jax_on_planted_band(fs):
    """Many hits on every channel, 6 errors allowed, the squelch on."""
    fj, ft = tp.pair(fs, max_ac_errors=6)
    with tp.pallas_interpret():
        assert _compare_flat_steps(fj, ft, tp.planted(fs, 24, seed=21)) >= 10


def test_flat_step_rejects_a_wrong_block_length():
    _, ft = tp.pair(4e6, max_ac_errors=1)
    with pytest.raises(ValueError, match="frames"):
        ft.device_step(np.zeros((2, ft.block_samples - 40), np.float32))
