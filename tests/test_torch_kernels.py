"""The port's kernel modules against the JAX package's Pallas kernels.

Each CUDA kernel of gr_bluetooth_tpu_torch has a plain PyTorch version
beside it, which is what runs for CPU tensors; here it is held to the
Pallas kernel it replaces, run in interpret mode on the same numpy
inputs:

  * pfb_snr        vs pfb_channelize_snr_fused (K3): y within 2e-5
  * slot SNR       vs assemble_fused_snr over the megakernel's (K1)
                   partials: within 1e-3 dB
  * demod_pack     vs demod_timing_pack (K4) on the same y: bit-exact;
                   and pfb_snr -> demod_pack vs the megakernel (K1) when
                   groups run past the data (all-ones tail words)
  * detect_words   vs detect_pallas.detect_words (K2): bit-exact
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gr_bluetooth_tpu.core import access_code
from gr_bluetooth_tpu.models.frontend import FrontEnd as JaxFrontEnd
from gr_bluetooth_tpu.ops import demod_kernel as jdemod
from gr_bluetooth_tpu.ops import detect_pallas as jdetect
from gr_bluetooth_tpu.ops import pfb_kernel as jpfb
from gr_bluetooth_tpu.ops import snr as jsnr
from gr_bluetooth_tpu.testing import PiconetSim, make_piconet_capture
from gr_bluetooth_tpu_torch.ops import demod_kernel, detect_kernel, pfb_kernel
from gr_bluetooth_tpu_torch.ops import snr
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS, CENTER = 4e6, 2441e6


@pytest.fixture(scope="module")
def block():
    """One 8-slot block of a golden 4 Msps capture, the JAX front end's
    constants, and the staged input its kernels take."""
    fe = JaxFrontEnd(FS, CENTER, block_slots=8, max_ac_errors=1,
                     use_pallas=False)
    sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    samples, _ = make_piconet_capture(sim, n_slots=16, fs=FS,
                                      center_freq=CENTER, seed=3,
                                      tx_slots=range(0, 10), noise_std=0.02)
    x = np.stack([samples.real, samples.imag]).astype(np.float32)
    x = x[:, : fe.block_samples]
    b, sc = fe.bank, fe.snr_consts
    pmr, pmi = jpfb.probe_phase_matrices(sc.taps_re, sc.taps_im)
    return dict(fe=fe, x=x, x3=jnp.asarray(fe.stage_block(x)), b=b, sc=sc,
                pmr=jnp.asarray(pmr), pmi=jnp.asarray(pmi))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bank_args(blk):
    b = blk["b"]
    return tuple(_t(a) for a in (b.h0, b.h1, b.dft_c, b.dft_s, b.bin_odd))


def _k3(blk):
    b = blk["b"]
    return jpfb.pfb_channelize_snr_fused(
        blk["x3"], jnp.asarray(b.h0), jnp.asarray(b.h1),
        jnp.asarray(b.dft_c), jnp.asarray(b.dft_s), jnp.asarray(b.bin_odd),
        b.decim, blk["pmr"], blk["pmi"], blk["sc"].slot_ch, interpret=True)


def _k1(blk, n_sym):
    b = blk["b"]
    return jpfb.pfb_channelize_snr_demod_fused(
        blk["x3"], jnp.asarray(b.h0), jnp.asarray(b.h1),
        jnp.asarray(b.dft_c), jnp.asarray(b.dft_s), jnp.asarray(b.bin_odd),
        b.decim, blk["pmr"], blk["pmi"], blk["sc"].slot_ch, b.demod_gain,
        n_sym, interpret=True)


def _n_frames(n):
    return -(-n // pfb_kernel.TF) * pfb_kernel.TF


def test_pfb_snr_plain_matches_k3(block):
    """Channel streams within 2e-5 of the Pallas channelizer on every
    frame of its data tiles (frames past the block's data included:
    both read zeros there)."""
    yr_j, yi_j, _, _ = (np.asarray(o) for o in _k3(block))
    n_tiles = yr_j.shape[1] // jpfb._TF - 1           # last tile is zeros
    F = n_tiles * jpfb._TF
    yr, yi, oe = pfb_kernel.pfb_snr(_t(block["x"]), *_bank_args(block),
                                    _n_frames(F))
    assert yr.shape == (yr_j.shape[0], _n_frames(F))
    np.testing.assert_allclose(yr[:, :F].numpy(), yr_j[:, :F], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(yi[:, :F].numpy(), yi_j[:, :F], atol=2e-5,
                               rtol=0)
    e = (yr ** 2 + yi ** 2).reshape(yr.shape[0], -1, pfb_kernel.TF).sum(-1)
    torch.testing.assert_close(oe, e, rtol=1e-5, atol=1e-6)


def test_slot_snr_matches_megakernel_assembly(block):
    """Slot SNR from the port's partials within 1e-3 dB of
    assemble_fused_snr over the megakernel's oe/pe."""
    fe, sc = block["fe"], block["sc"]
    n_y, n_sym = fe._step_kwargs["n_y"], fe.n_sym
    _, oe_j, pe_j = _k1(block, n_sym)
    S = n_y // sc.slot_ch
    ref = np.asarray(jsnr.assemble_fused_snr(
        oe_j, pe_j, S=S, slot_ch=sc.slot_ch, kappa=sc.kappa,
        C=block["b"].dft_c.shape[1] - 1, taps_len=len(sc.taps_re)))

    n_k = snr.probe_points(S, sc.slot_ch, len(sc.taps_re))
    yr, yi, oe = pfb_kernel.pfb_snr(_t(block["x"]), *_bank_args(block),
                                    _n_frames(n_y))
    _, pe = demod_kernel.demod_pack(yr, yi, block["b"].demod_gain, n_sym,
                                    _t(sc.taps_re), _t(sc.taps_im), n_k)
    got = snr.assemble_slot_snr(oe, pe, S=S, slot_ch=sc.slot_ch,
                                kappa=sc.kappa, tile=pfb_kernel.TF).numpy()
    assert got.shape == ref.shape == (S, block["b"].n_channels)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_demod_pack_plain_matches_k4(block):
    """Packed words bit-exact against demod_timing_pack on the same y
    (every row, the probe row included)."""
    sc, b = block["sc"], block["b"]
    yr_j, yi_j, _, _ = _k3(block)
    n_sym = block["fe"].n_sym
    ref = np.asarray(jdemod.demod_timing_pack(yr_j, yi_j, b.demod_gain,
                                              n_sym, interpret=True))
    n_k = snr.probe_points(n_sym * 2 // sc.slot_ch, sc.slot_ch,
                           len(sc.taps_re))
    words, pe = demod_kernel.demod_pack(_t(yr_j), _t(yi_j), b.demod_gain,
                                        n_sym, _t(sc.taps_re),
                                        _t(sc.taps_im), n_k)
    assert words.dtype == torch.int32 and words.shape == ref.shape
    assert np.array_equal(words.numpy(), ref)
    assert pe.shape == (ref.shape[0], n_k) and bool((pe > 0).all())


def test_demod_pack_tail_groups_match_megakernel(block):
    """With more symbols than the block has frames, the megakernel writes
    all-ones words for groups past its data tiles; pfb_snr -> demod_pack
    with the same data-group count gives the same words, bit for bit."""
    sc, b = block["sc"], block["b"]
    n = block["x"].shape[1] // b.decim - 2 * b.h0.shape[0]
    n_data = -(-n // demod_kernel.GROUP_FRAMES)
    n_sym = n_data * demod_kernel.GROUP + 700         # two groups past data
    assert -(-n_sym // demod_kernel.GROUP) == n_data + 2
    ref = np.asarray(_k1(block, n_sym)[0])
    n_k = snr.probe_points(n // sc.slot_ch, sc.slot_ch, len(sc.taps_re))
    yr, yi, _ = pfb_kernel.pfb_snr(
        _t(block["x"]), *_bank_args(block),
        _n_frames(demod_kernel.GROUP_FRAMES * n_data + 2))
    words, _ = demod_kernel.demod_pack(yr, yi, b.demod_gain, n_sym,
                                       _t(sc.taps_re), _t(sc.taps_im), n_k,
                                       n_data)
    assert words.shape == ref.shape
    tail = ref[:, n_data * demod_kernel.GROUP // 32: -1]
    assert (tail == -1).all() and tail.size
    assert np.array_equal(words.numpy(), ref)


def _planted_words(seed, C, T, plants):
    r = np.random.default_rng(seed)
    bits = r.integers(0, 2, (C, T)).astype(np.int8)
    for c, off, lap, flips in plants:
        ac = access_code.ac_bits(lap)[:68].copy()
        for j in flips:                      # parity-region bit errors
            ac[j] ^= 1
        bits[c, off:off + 68] = ac
    words = np.asarray(jdetect.pack_bits_words(bits))
    return bits, words


@pytest.mark.parametrize("max_ac_errors", [1, 6])
def test_detect_words_plain_matches_k2(max_ac_errors):
    """Hit and gate planes bit-exact on random words with access codes
    planted across the Pallas kernel's tile edges (128 words = 4096
    offsets) and at the first and last offsets."""
    C, T = 8, 9000
    n = T - 71
    plants = [(0, 0, 0x123456, ()), (1, 250, 0x9E8B33, (5,)),
              (2, 255, 0xABCDEF, ()), (3, 256, 0x000000, (4, 9)),
              (4, 257, 0xFFFFFF, ()), (5, 511, 0x5A17EC, (7, 12, 20)),
              (6, 4064, 0x24D952, ()), (7, 4095, 0x24D952, (6,)),
              (0, 4096, 0x9E8B33, ()), (1, 4097, 0x123456, (30,)),
              (2, n - 1, 0xABCDEF, ()), (3, 512, 0x5A17EC, (33,)),
              (4, 513, 0x24D952, ()), (5, 1000, 0x9E8B33, (11, 14))]
    bits, words = _planted_words(11, C, T, plants)
    hit_j, gate_j, _ = jdetect.detect_words(jnp.asarray(words), n,
                                            max_ac_errors, interpret=True,
                                            emit_err=False)
    masks = torch.from_numpy(detect_kernel.ac_masks())
    hit, gate, err = detect_kernel.detect_words(_t(words), n,
                                                max_ac_errors, masks)
    assert err is None
    assert np.array_equal(hit.numpy(), np.asarray(hit_j))
    assert np.array_equal(gate.numpy(), np.asarray(gate_j))

    def bit(plane, c, o):
        return (int(plane[c, o // 32]) >> (o % 32)) & 1

    h = hit.numpy()
    for c, off, _, flips in plants:
        assert bit(h, c, off) == (len(flips) <= max_ac_errors), (c, off)


def test_ac_masks_match_affine_code():
    """The packed masks hold A68's columns and C68 bit for bit."""
    A, Cv = access_code.affine_code()
    m = detect_kernel.ac_masks().view(np.uint32).astype(np.int64)
    for k in range(24):
        v = int(m[3 * k]) | (int(m[3 * k + 1]) << 32) | \
            (int(m[3 * k + 2]) << 64)
        assert [(v >> j) & 1 for j in range(68)] == list(A[:68, k])
    v = int(m[72]) | (int(m[73]) << 32) | (int(m[74]) << 64)
    assert [(v >> j) & 1 for j in range(68)] == list(Cv[:68])


def test_pack_bits_words_matches_jax():
    r = np.random.default_rng(4)
    for T in (31, 32, 33, 95, 96, 1000):
        bits = r.integers(0, 2, (3, T)).astype(np.int8)
        got = detect_kernel.pack_bits_words(_t(bits))
        assert np.array_equal(got.numpy(),
                              np.asarray(jdetect.pack_bits_words(bits)))


def test_atan2_poly_matches_jax():
    """Operation for operation the JAX polynomial: bit-identical."""
    r = np.random.default_rng(8)
    y = r.normal(size=4096).astype(np.float32)
    x = r.normal(size=4096).astype(np.float32)
    y[:4] = [0.0, 0.0, 1.0, -1.0]
    x[:4] = [0.0, -1.0, 0.0, 0.0]
    got = demod_kernel.atan2_poly(_t(y), _t(x)).numpy()
    ref = np.asarray(jdemod.atan2_poly(jnp.asarray(y), jnp.asarray(x)))
    assert np.array_equal(got, ref)
