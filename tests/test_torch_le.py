"""The port's LE branch against the JAX package.

  * exact: the whitening words, the distance tables and channel maps,
    the per-row LE constants (also as convert.consts_from_jax carries
    them), the LE detector (_le_detect_batch_impl), the dense first-k
    extraction (_extract_hits), the dense squelch gate (_squelch_gate)
    and the word-row unpack (_unpack_word_rows);
  * the LE outputs of both chains on a capture with LE advertising and
    data packets from the JAX package's encoders (8 Msps centred on
    2426 MHz, which holds advertising channel 38): the flat step against
    the JAX step on flat planes, the fused step against the JAX step on
    the staged layout, stream() and stream_sync() against the JAX
    stream(): identical LE counts, tables and windows;
  * the full-band counterpart of tests/test_fullband.py: an advertising
    packet on BR channel 78 comes out of LE row index 39 on both chains.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from gr_bluetooth_tpu.constants import SYMBOLS_PER_SLOT
from gr_bluetooth_tpu.core import le_tables as jle_tables
from gr_bluetooth_tpu.core import packets as jpackets
from gr_bluetooth_tpu.core import whitening as jwhitening
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.ops import detect as jdetect
from gr_bluetooth_tpu.ops import synth as jsynth
from gr_bluetooth_tpu_torch.core import le_tables, whitening
from gr_bluetooth_tpu_torch.models import frontend
from gr_bluetooth_tpu_torch.ops import detect
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_whitening_words_equal_jax():
    assert np.array_equal(whitening.SEQUENCE, jwhitening.SEQUENCE)
    assert np.array_equal(whitening.LE_INDEX, jwhitening.LE_INDEX)
    for index in range(40):
        for length, skip in ((16, 0), (300, 0), (40, 7), (127, 126)):
            assert np.array_equal(
                whitening.le_whitening_word(index, length, skip),
                jwhitening.le_whitening_word(index, length, skip))


def test_le_tables_equal_jax():
    for name in ("LE_PREAMBLE_DISTANCE", "AA_DISTANCE", "LE_CHAN2INDEX"):
        a, b = getattr(le_tables, name), getattr(jle_tables, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("ACCESS_HEADER_DISTANCE", "DATA_HEADER_DISTANCE"):
        for a, b in zip(getattr(le_tables, name), getattr(jle_tables, name)):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for f in np.arange(2395e6, 2486e6, 0.5e6):
        assert le_tables.freq2index(f) == jle_tables.freq2index(f)
        assert le_tables.freq2chan(f) == jle_tables.freq2chan(f)


def test_le_row_consts_equal_jax():
    idx = [0, 10, 11, 36, 37, 38, 39]
    for a, b in zip(detect.le_row_consts(idx), jdetect.le_row_consts(idx)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fs,center", [(8e6, 2426e6), (80e6, 2441e6)])
def test_le_consts_from_jax_equal_port_consts(fs, center):
    fj = jfrontend.FrontEnd(fs, center, block_slots=8, enable_le=True,
                            use_pallas=True)
    ft = frontend.FrontEnd(fs, center, block_slots=8, enable_le=True,
                           device="cpu")
    assert ft.le_rows == fj.le_rows and ft.max_le_hits == fj.max_le_hits
    kw = {k: (np.asarray(v) if hasattr(v, "shape") else v)
          for k, v in fj._step_kwargs.items()}
    consts, statics = tp.convert.consts_from_jax(kw)
    assert statics == ft.statics
    assert consts.keys() == ft.consts.keys()
    for k, v in consts.items():
        assert v.dtype == ft.consts[k].dtype and torch.equal(v, ft.consts[k]), k
    assert ft.consts["le_rows"].dtype == torch.int64


def _le_rows_bits(seed, R=6, T=3000):
    """Random symbol rows with LE frames (advertising on index 37-39
    rows, data elsewhere) planted, some with flipped bits."""
    r = np.random.default_rng(seed)
    idx = [37, 5, 38, 20, 39, 36][:R]
    bits = r.integers(0, 2, (R, T)).astype(np.int8)
    for row, index in enumerate(idx):
        for k, off in enumerate((17, 900, 1800, T - 120)):
            if index >= 37:
                f = jpackets.encode_le_adv(0x8E89BED6, index, k % 7,
                                           bytes(range(8)), crc=False)
            else:
                f = jpackets.encode_le_data(0x1234567 + k, index, 1 + k % 3,
                                            bytes(range(5)), 0x555555)
            f = f[:120].copy()
            if k == 1:
                f[12] ^= 1                 # one AA bit wrong
            if k == 2:
                f[3] ^= 1
                f[30] ^= 1
            bits[row, off: off + len(f)] = f
    return idx, bits


def test_le_detect_batch_matches_jax():
    idx, bits = _le_rows_bits(1)
    white, aa_on, max_dist = detect.le_row_consts(idx)
    hj, dj = (np.asarray(a) for a in jdetect._le_detect_batch_impl(
        jnp.asarray(bits.astype(np.float32)), jnp.asarray(white),
        jnp.asarray(aa_on), jnp.asarray(max_dist)))
    tables = {k: _t(v) for k, v in detect.le_table_consts().items()}
    h, d = detect.le_detect_batch(_t(bits), _t(white), _t(aa_on),
                                  _t(max_dist), **tables)
    assert h.dtype == torch.bool and d.dtype == torch.int32
    assert np.array_equal(h.numpy(), hj) and np.array_equal(d.numpy(), dj)
    assert hj.sum() >= 10


@pytest.mark.parametrize("k", [4, 50, 5000])
def test_extract_hits_matches_jax(k):
    r = np.random.default_rng(k)
    mask = r.random((7, 3000)) < 0.01
    payload = r.integers(-5, 50, (7, 3000)).astype(np.int32)
    cj, tj, chj, ofj, vj = (np.asarray(a) for a in jfrontend._extract_hits(
        jnp.asarray(mask), k, [jnp.asarray(payload)]))
    ct, tt, cht, oft, vt = frontend._extract_hits(_t(mask), k, [_t(payload)])
    assert int(ct) == int(cj) and np.array_equal(vt.numpy(), vj)
    assert tt.dtype == torch.int32 and np.array_equal(tt.numpy(), tj)
    assert np.array_equal(cht.numpy()[vj], chj[vj])
    assert np.array_equal(oft.numpy()[vj], ofj[vj])


@pytest.mark.parametrize("n,delay", [(5000, 4), (8070, 7), (3126, 0)])
def test_squelch_gate_matches_jax(n, delay):
    snr_db = np.random.default_rng(n).normal(10, 4, (8, 5)).astype(
        np.float32)
    ref = np.asarray(jfrontend._squelch_gate(jnp.asarray(snr_db), n, delay,
                                             10.0))
    got = frontend._squelch_gate(_t(snr_db), n, delay, 10.0)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)


def test_unpack_word_rows_matches_jax():
    r = np.random.default_rng(3)
    words = r.integers(-2 ** 31, 2 ** 31, (9, 40), dtype=np.int64).astype(
        np.int32)
    rows = np.array([0, 4, 8, 2])
    ref = np.asarray(jfrontend._unpack_word_rows(jnp.asarray(words),
                                                 jnp.asarray(rows), 1270))
    got = frontend._unpack_word_rows(_t(words), _t(rows), 1270)
    assert np.array_equal(got.numpy(), ref)


@pytest.fixture(scope="module")
def le_pair():
    x, want = tp.le_capture()
    fj, ft = tp.pair(8e6, tp.LE_CENTER, max_ac_errors=1, enable_le=True)
    return fj, ft, x, want


def _assert_outputs_equal(ot, oj):
    oj = [np.asarray(o) for o in oj]
    np.testing.assert_allclose(ot[0].numpy(), oj[0], atol=1e-3, rtol=0)
    for i in (1, 2, 4, 5):
        assert np.array_equal(ot[i].numpy(), oj[i]), i
    tp.assert_windows_agree(ot[3].numpy(), oj[3])
    tp.assert_windows_agree(ot[6].numpy(), oj[6])
    return int(oj[4])


def test_both_chains_le_outputs_match_jax(le_pair):
    fj, ft, x, _ = le_pair
    n_le = 0
    with tp.pallas_interpret():
        for xb in tp.blocks(fj, x):
            n_le += _assert_outputs_equal(ft.device_step(xb),
                                          fj._jit_step(jnp.asarray(xb)))
            _assert_outputs_equal(
                ft.fused_step(xb),
                fj._jit_step(jnp.asarray(fj.stage_block(xb))))
    assert n_le >= 15


def _le_key(results):
    return [[(h.channel, h.index, h.clkn, h.sym_offset, h.distance,
              h.win_row) for h in r.le_hits] for r in results]


def test_stream_le_hits_match_jax(le_pair):
    """stream() (fused) and stream_sync() (flat) against the JAX
    stream(): the same LE hits, and every planted LE packet among them
    at its slot, its window holding the planted frame."""
    fj, ft, x, want = le_pair
    with tp.pallas_interpret():
        ref = list(fj.stream(x, start_clkn=40))
    got = list(ft.stream(x, start_clkn=40))
    sync = list(ft.stream_sync(x, start_clkn=40))
    assert _le_key(got) == _le_key(sync) == _le_key(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose([h.snr_db for h in a.le_hits],
                                   [h.snr_db for h in b.le_hits], atol=1e-3,
                                   rtol=0)
        for ha, hb in zip(a.le_hits, b.le_hits):
            assert np.array_equal(ft.le_packet_symbols(a, ha),
                                  fj.le_packet_symbols(b, hb))
    seen = {(h.channel, h.clkn - 40) for r in got for h in r.le_hits}
    for kind, ch, slot in want:
        if kind != "classic":
            assert {(ch, slot), (ch, slot + 1)} & seen, (kind, ch, slot)


@pytest.fixture(scope="module")
def fullband():
    """80 Msps, 8-slot blocks: classic packets on channels 0 / 40 / 78,
    one LE advertising packet on BR channel 78 (LE index 39), as
    tests/test_fullband.py plants them."""
    fs, sps = 80e6, 80
    rng = np.random.default_rng(3)
    plan = []
    for slot, ch in [(1, 0), (2, 40), (3, 78), (4, 0), (5, 78)]:
        bits = jpackets.encode_classic_packet(
            0x24D952, 0x47, slot, 3, bytes(rng.integers(0, 256, 6).tolist()))
        plan.append(jsynth.PlannedPacket(
            channel=ch, bits=bits,
            start_sample=slot * SYMBOLS_PER_SLOT * sps + 10 * sps))
    le_bits = jpackets.encode_le_adv(0x8E89BED6, 39, 0, b"\x11" * 8)
    plan.append(jsynth.PlannedPacket(
        channel=78, start_sample=6 * SYMBOLS_PER_SLOT * sps + 10 * sps,
        bits=np.concatenate([le_bits, np.zeros(8, np.uint8)])))
    x = jsynth.synthesize_capture(plan, n_samples=16 * SYMBOLS_PER_SLOT * sps,
                                  fs=fs, center_freq=2441e6, noise_std=0.02,
                                  seed=3)
    fe = frontend.FrontEnd(fs, 2441e6, block_slots=8, enable_le=True,
                           device="cpu")
    return fe, x


@pytest.mark.parametrize("chain", ["stream", "stream_sync"])
def test_fullband_le_row(fullband, chain):
    fe, x = fullband
    assert fe.bank.n_channels == 79 and len(fe.le_rows) == 40
    results = list(getattr(fe, chain)(x))
    le = [h for r in results for h in r.le_hits]
    assert any(h.channel == 78 and h.index == 39 and h.clkn == 6
               for h in le), le
    got = {(h.clkn, h.channel) for r in results for h in r.hits
           if h.errors <= 2}
    assert got == {(1, 0), (2, 40), (3, 78), (4, 0), (5, 78)}
