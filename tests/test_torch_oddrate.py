"""The odd-integer and off-grid front ends of the port against the JAX
package's, on the same inputs made from a seed with numpy.

  * the conv bank (make_bank: kernel and rot_q) and the slot-SNR weights
    (make_snr_weights) are the same NumPy code: equal exactly;
  * channelize within 2e-5 of the JAX conv bank, slot_snr within
    1e-3 dB, at 3 and 5 Msps;
  * the resampler (the same NumPy code) bit-identical, and
    tests/test_resample.py's cases through the port;
  * the FrontEnd at 3, 5 and 2.5 Msps, through stream() and
    stream_sync(): hit tables (classic and LE) and windows equal to the
    JAX FrontEnd's on its packed path (use_pallas=True, the Pallas
    detector in interpret mode), slot SNR within 1e-3 dB.  At 2.5 Msps
    both packages resample to 4 Msps and run the polyphase bank on the
    one channel the true band holds; there the two packages'
    discriminators differ (torch.atan2 / atan2_poly against the TPU
    kernel's), so windows agree within one symbol per 10^5, as in
    tests/test_torch_frontend.py.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.ops import channelizer as jchannelizer
from gr_bluetooth_tpu.ops import resample as jresample
from gr_bluetooth_tpu.ops import snr as jsnr
from gr_bluetooth_tpu_torch import testing
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.ops import channelizer, resample, snr
from torch_parity import (assert_windows_agree, one_torch_thread,  # noqa: F401
                          pallas_interpret)

CENTER = 2441e6
LAP, UAP = 0x24D952, 0x47


def capture(fs, n_slots=40, seed=5):
    """Planes of a piconet capture at fs on channel 39, a DM1 every other
    slot; off-grid rates are synthesized at an integer rate above and
    resampled to fs."""
    fs_syn = fs if float(fs / 1e6).is_integer() else 10e6
    # a master on channel 39, the one BR channel a 2.5 Msps band holds
    sim = chip_smoke.OneChannelSim(lap=LAP, uap=UAP, clk0=0x12780)
    x, sent = testing.make_piconet_capture(
        sim, n_slots=n_slots, fs=fs_syn, center_freq=CENTER, seed=seed,
        tx_slots=range(0, n_slots - 6, 2), noise_std=0.01)
    x = np.stack([x.real, x.imag]).astype(np.float32)
    if fs_syn != fs:
        x = resample.make_resampler(fs_syn, fs)(x)
    return x, sent


@pytest.mark.parametrize("fs", [3e6, 5e6, 9e6, 81e6])
def test_conv_bank_and_snr_weights_equal_jax(fs):
    bt, bj = channelizer.make_bank(fs, CENTER), jchannelizer.make_bank(
        fs, CENTER)
    for f in ("fs", "center_freq", "sps", "decim", "ch_sps", "channels",
              "ntaps", "demod_gain"):
        assert getattr(bt, f) == getattr(bj, f), f
    for f in ("kernel", "rot_q"):
        a, b = getattr(bt, f), getattr(bj, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    wt, wj = snr.make_snr_weights(bt), jsnr.make_snr_weights(bj)
    assert wt.slot_len == wj.slot_len == 625 * bt.sps
    for f in ("on_w", "off_w"):
        a, b = getattr(wt, f), getattr(wj, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if fs == 81e6:
        assert bt.n_channels == 79 and wt.on_w.shape == (50625, 79)


@pytest.mark.parametrize("fs", [3e6, 5e6])
def test_channelize_and_slot_snr_match_jax(fs):
    """y within 2e-5 (torch conv1d against XLA's convolution, sums in
    another order), slot SNR within 1e-3 dB."""
    x, _ = capture(fs, n_slots=12)
    xc = (x[0] + 1j * x[1]).astype(np.complex64)
    bank = channelizer.make_bank(fs, CENTER)
    yr, yi = channelizer.channelize(xc, bank, n0=3, device="cpu")
    jr, ji = jchannelizer.channelize(xc, jchannelizer.make_bank(fs, CENTER),
                                     n0=3)
    assert yr.shape == jr.shape == (bank.n_channels,
                                    (x.shape[1] - bank.ntaps)
                                    // bank.decim + 1)
    assert np.abs(yr.numpy() - np.asarray(jr)).max() <= 2e-5
    assert np.abs(yi.numpy() - np.asarray(ji)).max() <= 2e-5
    w = snr.make_snr_weights(bank)
    got = snr.slot_snr(x, w, device="cpu")
    want = jsnr.slot_snr(x, jsnr.make_snr_weights(
        jchannelizer.make_bank(fs, CENTER)))
    assert got[0].shape == (x.shape[1] // w.slot_len, bank.n_channels)
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() <= 1e-3
    # the complex form of the input gives the same SNR
    assert torch.equal(snr.slot_snr(xc, w, device="cpu")[0], got[0])


@pytest.mark.parametrize("fs_in,fs_out", [(2.5e6, 4e6), (7.68e6, 8e6),
                                          (10e6, 2.5e6), (8e6, 7.68e6)])
def test_resampler_bit_identical(fs_in, fs_out):
    rt = resample.make_resampler(fs_in, fs_out)
    rj = jresample.make_resampler(fs_in, fs_out)
    assert (rt.L, rt.M, rt.Q) == (rj.L, rj.M, rj.Q)
    assert rt.taps.dtype == rj.taps.dtype and np.array_equal(rt.taps,
                                                             rj.taps)
    x = np.random.default_rng(4).normal(size=(2, 7001)).astype(np.float32)
    assert np.array_equal(rt(x), rj(x))
    parts_t = [rt.push(x[:, :1234]), rt.push(x[:, 1234:])]
    parts_j = [rj.push(x[:, :1234]), rj.push(x[:, 1234:])]
    for a, b in zip(parts_t, parts_j):
        assert np.array_equal(a, b)
    assert resample.pick_internal_rate(fs_in) == \
        jresample.pick_internal_rate(fs_in)


def test_tone_preserved():
    r = resample.make_resampler(2.5e6, 4e6)
    assert (r.L, r.M) == (8, 5)
    n = 4096
    t = np.arange(n) / 2.5e6
    f0 = 300e3
    x = np.stack([np.cos(2 * np.pi * f0 * t),
                  np.sin(2 * np.pi * f0 * t)]).astype(np.float32)
    y = r(x)
    m = y.shape[1]
    ty = np.arange(m) / 4e6
    d = (r.Q - 1) / 2 / 2.5e6
    ref = np.cos(2 * np.pi * f0 * (ty - d))
    core = slice(r.Q * 2, m - r.Q * 2)
    assert np.max(np.abs(y[0, core] - ref[core])) < 0.02


def test_streaming_equals_oneshot():
    r = resample.make_resampler(2.5e6, 4e6)
    x = np.random.default_rng(0).normal(size=(2, 10000)).astype(np.float32)
    one = r(x)
    r.reset()
    parts = [r.push(x[:, :1000]), r.push(x[:, 1000:4321]),
             r.push(x[:, 4321:4322]), r.push(x[:, 4322:])]
    chunked = np.concatenate(parts, axis=1)
    n = min(one.shape[1], chunked.shape[1])
    assert np.array_equal(one[:, :n], chunked[:, :n])
    assert abs(one.shape[1] - chunked.shape[1]) <= 1


def test_e2e_2p5_msps_golden():
    """A true 2.5 Msps capture (synthesized at 10 Msps, decimated)
    through the port's resampling front end on the CPU."""
    x25, sent = capture(2.5e6)
    sn = Sniffer(2.5e6, CENTER, block_slots=8, enable_le=False,
                 device="cpu")
    assert sn.fe.resampler is not None and sn.fe.is_pfb
    assert sn.fe.bank.fs == resample.pick_internal_rate(2.5e6) == 4e6
    assert sn.fe.bank.channels == (39,)
    sn.run(x25)
    pn = sn.basic_rate_piconets.get(LAP)
    assert pn is not None, "LAP not discovered at 2.5 Msps"
    assert pn.uap == UAP
    assert len(sn.decoded) >= len(sent) // 2


def _keys(results):
    hits = [(r.slot_base, h.channel, h.chan_idx, h.clkn, h.sym_offset,
             h.lap, h.errors, h.win_row) for r in results for h in r.hits]
    le = [(r.slot_base, h.channel, h.index, h.clkn, h.sym_offset,
           h.distance, h.win_row) for r in results for h in r.le_hits]
    return hits, le


@pytest.fixture(scope="module", params=[3e6, 5e6, 2.5e6])
def rate_pair(request):
    fs = request.param
    x, _ = capture(fs, seed=7)
    ft = FrontEnd(fs, CENTER, block_slots=8, enable_le=True, device="cpu")
    fj = jfrontend.FrontEnd(fs, CENTER, block_slots=8, enable_le=True,
                            use_pallas=True)
    return fs, x, ft, fj


@pytest.mark.parametrize("chain", ["stream", "stream_sync"])
def test_front_end_matches_jax(rate_pair, chain):
    fs, x, ft, fj = rate_pair
    assert ft.is_pfb == (fj.weights is None) == (fs == 2.5e6)
    assert ft.bank.channels == fj.bank.channels
    assert (ft.resampler is None) == (fj.resampler is None)
    assert (ft.step_samples, ft.overlap_samples, ft.n_sym, ft.delay_sym) == \
        (fj.step_samples, fj.overlap_samples, fj.n_sym, fj.delay_sym)
    got = list(getattr(ft, chain)(x))
    with pallas_interpret():
        want = list(getattr(fj, chain)(x))
    assert len(got) == len(want) >= 4
    assert _keys(got) == _keys(want)
    assert sum(len(r.hits) for r in got) >= 10
    for a, b in zip(got, want):
        assert np.abs(a.snr_db - np.asarray(b.snr_db)).max() <= 1e-3
        if ft.is_pfb:
            assert_windows_agree(a.windows, np.asarray(b.windows))
            assert_windows_agree(a.le_windows, np.asarray(b.le_windows))
        else:
            assert np.array_equal(a.windows, np.asarray(b.windows))
            assert np.array_equal(a.le_windows, np.asarray(b.le_windows))
