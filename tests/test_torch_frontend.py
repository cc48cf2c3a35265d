"""The port's fused chain (FrontEnd.fused_step, which stream() runs)
against the JAX package's step on the staged layout.

The JAX side runs its main path: the staged input through the Pallas
megakernel, the packed detector, packed squelch, packed hit extraction
and the bit-aligned window gather, with the Pallas kernels in interpret
mode.  The port runs the plain PyTorch versions of its kernels on the
CPU, on the constants carried across with convert.consts_from_jax.
Hit counts, hit tables and windows must be identical; the slot SNR
agrees within 1e-3 dB (sums run in another order).  The flat chain
(FrontEnd.device_step) has its own tests in tests/test_torch_flat.py;
its table overflow is held here beside the fused chain's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gr_bluetooth_tpu.constants import SYMBOLS_PER_SLOT
from gr_bluetooth_tpu.core import access_code
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.ops import detect_pallas
from gr_bluetooth_tpu.ops import synth as jsynth
from gr_bluetooth_tpu.testing import PiconetSim, make_piconet_capture
from gr_bluetooth_tpu_torch import convert
from gr_bluetooth_tpu_torch.models import frontend
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def interpret():
    old = detect_pallas.DEFAULT_INTERPRET
    detect_pallas.DEFAULT_INTERPRET = True
    try:
        yield
    finally:
        detect_pallas.DEFAULT_INTERPRET = old


def _piconet(fs, n_blocks, seed=3):
    sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    n_slots = 8 * n_blocks + 8
    samples, _ = make_piconet_capture(sim, n_slots=n_slots, fs=fs,
                                      center_freq=2441e6, seed=seed,
                                      tx_slots=range(0, n_slots - 6),
                                      noise_std=0.02)
    return np.stack([samples.real, samples.imag]).astype(np.float32)


def _planted(fs, n_slots, seed):
    """ID packets (access code + random tail) with several LAPs on every
    channel of the band, some in the same slot, at random jitter."""
    sps = int(fs // 1e6)
    r = np.random.default_rng(seed)
    n_ch = int(fs // 1e6) - 1
    laps = [0x24D952, 0x9E8B33, 0x123456, 0xABCDEF, 0x5A17EC, 0x000F0F]
    plan = []
    for i in range(3 * n_ch):
        ch = 2441 - 2402 - n_ch // 2 + (i % n_ch)
        slot = 1 + (i * 5) % (n_slots - 7)
        bits = np.concatenate([access_code.ac_bits(laps[i % len(laps)])[:72],
                               r.integers(0, 2, 60).astype(np.uint8)])
        plan.append(jsynth.PlannedPacket(
            channel=ch, bits=bits,
            start_sample=(slot * SYMBOLS_PER_SLOT
                          + int(r.integers(0, 300))) * sps))
    x = jsynth.synthesize_capture(plan, n_samples=n_slots * SYMBOLS_PER_SLOT
                                  * sps, fs=fs, center_freq=2441e6,
                                  noise_std=0.02, seed=seed)
    return np.stack([x.real, x.imag]).astype(np.float32)


def _pair(fs, **kw):
    """(JAX front end on its packed Pallas path, the port's front end on
    the CPU holding the JAX front end's constants)."""
    fj = jfrontend.FrontEnd(fs, 2441e6, block_slots=8, use_pallas=True, **kw)
    ft = frontend.FrontEnd(fs, 2441e6, block_slots=8, device="cpu", **kw)
    kwargs = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in fj._step_kwargs.items()}
    ft.consts, statics = convert.consts_from_jax(kwargs)
    assert statics == ft.statics
    return fj, ft


def _compare_steps(fj, ft, x):
    n_blocks = (x.shape[1] - fj.overlap_samples) // fj.step_samples
    total = 0
    for i in range(n_blocks):
        xb = x[:, i * fj.step_samples: i * fj.step_samples + fj.block_samples]
        oj = fj._jit_step(jnp.asarray(fj.stage_block(xb)))
        ot = ft.fused_step(xb)
        assert ot[4:] == (None, None, None)
        snr_j, snr_t = np.asarray(oj[0]), ot[0].numpy()
        assert snr_t.dtype == np.float32 and snr_t.shape == snr_j.shape
        np.testing.assert_allclose(snr_t, snr_j, atol=1e-3, rtol=0)
        assert int(ot[1]) == int(oj[1])
        assert np.array_equal(ot[2].numpy(), np.asarray(oj[2]))
        assert np.array_equal(ot[3].numpy(), np.asarray(oj[3]))
        total += int(oj[1])
    return total


@pytest.mark.parametrize("fs", [4e6, 8e6])
def test_device_step_matches_jax_on_piconet_golden(fs, interpret):
    fj, ft = _pair(fs, max_ac_errors=1)
    assert _compare_steps(fj, ft, _piconet(fs, n_blocks=2)) > 0


def test_device_step_matches_jax_on_planted_band(interpret):
    """Many hits on every channel of an 8 Msps band, 6 errors allowed,
    the squelch on: identical tables, windows and counts."""
    fj, ft = _pair(8e6, max_ac_errors=6)
    assert _compare_steps(fj, ft, _planted(8e6, 24, seed=21)) >= 20


def test_hit_table_overflow_keeps_count(interpret):
    """More detections than max_hits: the count keeps the total, the
    table holds the first max_hits in channel-major order, as on JAX."""
    fj, ft = _pair(8e6, max_ac_errors=6, max_hits=4, use_squelch=False)
    x = _planted(8e6, 16, seed=5)
    xb = x[:, : fj.block_samples]
    oj = fj._jit_step(jnp.asarray(fj.stage_block(xb)))
    ot = ft.fused_step(xb)
    assert int(ot[1]) == int(oj[1]) > 4
    assert np.array_equal(ot[2].numpy(), np.asarray(oj[2]))
    assert np.array_equal(ot[3].numpy(), np.asarray(oj[3]))


def test_flat_hit_table_overflow_keeps_count(interpret):
    """The same overflow through the flat chain against the JAX step on
    flat planes: the same count and first max_hits rows."""
    fj, ft = _pair(8e6, max_ac_errors=6, max_hits=4, use_squelch=False)
    xb = _planted(8e6, 16, seed=5)[:, : fj.block_samples]
    oj = fj._jit_step(jnp.asarray(xb))
    ot = ft.device_step(xb)
    assert int(ot[1]) == int(oj[1]) > 4
    assert np.array_equal(ot[2].numpy(), np.asarray(oj[2]))


def test_extract_and_gather_match_jax():
    """The packed first-k extraction and the bit-aligned window gather on
    random planes: same (count, chan, off) on valid rows, same windows."""
    r = np.random.default_rng(2)
    C, W = 6, 40
    hitw = (r.integers(0, 2 ** 32, (C, W), dtype=np.uint64) &
            r.integers(0, 2 ** 32, (C, W), dtype=np.uint64) &
            r.integers(0, 2 ** 32, (C, W), dtype=np.uint64))
    hitw[r.random((C, W)) < 0.8] = 0
    hitw = hitw.astype(np.uint32).view(np.int32)
    words = r.integers(-2 ** 31, 2 ** 31, (C, 120), dtype=np.int64)
    words = words.astype(np.int32)
    for k in (8, 1000):
        cj, chj, ofj, vj = (np.asarray(a) for a in
                            jfrontend._extract_hits_packed(jnp.asarray(hitw),
                                                           k))
        ct, cht, oft, vt = frontend._extract_hits_packed(
            torch.from_numpy(hitw), k)
        assert int(ct) == int(cj)
        assert np.array_equal(vt.numpy(), vj)
        assert np.array_equal(cht.numpy()[vj], chj[vj])
        assert np.array_equal(oft.numpy()[vj], ofj[vj])
        offs = np.where(vj, ofj, 0) % (120 * 32)
        chans = np.where(vj, chj, 0)
        wj = np.asarray(jfrontend._gather_windows(
            jnp.asarray(words), jnp.asarray(chans), jnp.asarray(offs),
            jnp.asarray(vj), 3200))
        wt = frontend._gather_windows(torch.from_numpy(words),
                                      torch.from_numpy(chans.astype(np.int64)),
                                      torch.from_numpy(offs.astype(np.int64)),
                                      torch.from_numpy(vj.copy()), 3200)
        assert np.array_equal(wt.numpy(), wj)


def test_squelch_gate_words_match_jax():
    r = np.random.default_rng(6)
    n_words, delay = 250, 7
    s0, ma = jfrontend._word_slot_consts(n_words, delay)
    S = int(s0.max()) + 1
    snr_db = r.normal(10.0, 4.0, (S, 5)).astype(np.float32)
    ref = np.asarray(jfrontend._squelch_gate_words(
        jnp.asarray(snr_db), jnp.asarray(s0), jnp.asarray(ma), 10.0))
    got = frontend._squelch_gate_words(
        torch.from_numpy(snr_db), torch.from_numpy(s0.astype(np.int64)),
        torch.from_numpy(ma), 10.0)
    assert np.array_equal(got.numpy(), ref)
