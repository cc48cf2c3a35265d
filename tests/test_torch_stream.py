"""The port's streaming paths and LAP survey against the JAX package.

FrontEnd.stream (the pipelined ingest: wire decode and overlap carry on
the device, packed single-buffer outputs, the fused chain) must give the
same hits as the JAX package's FrontEnd.stream on its packed Pallas path
(interpret mode), and the same hits, windows and SNR (within 1e-4 dB) as
FrontEnd.stream_sync, which runs the other chain (deinterleave,
pfb_channelize, the torch demodulator); LapSurvey must report the same
observations as the JAX LapSurvey.
"""
import numpy as np
import pytest

from gr_bluetooth_tpu.constants import SYMBOLS_PER_SLOT
from gr_bluetooth_tpu.core import access_code
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.models import lap_survey as jlap_survey
from gr_bluetooth_tpu.ops import detect_pallas, synth
from gr_bluetooth_tpu_torch.models import frontend, lap_survey
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS, CENTER = 8e6, 2441e6
LAPS = (0x24D952, 0x9E8B33, 0x123456, 0x5A17EC)


@pytest.fixture
def interpret():
    old = detect_pallas.DEFAULT_INTERPRET
    detect_pallas.DEFAULT_INTERPRET = True
    try:
        yield
    finally:
        detect_pallas.DEFAULT_INTERPRET = old


@pytest.fixture(scope="module")
def capture():
    """Three and a bit 8-slot blocks (the tail block is zero-padded) of
    ID packets with four LAPs on every channel of the 8 Msps band."""
    sps = int(FS // 1e6)
    r = np.random.default_rng(7)
    plan = []
    for i in range(28):
        slot = 1 + (i * 3) % 24
        bits = np.concatenate([access_code.ac_bits(LAPS[i % 4])[:72],
                               r.integers(0, 2, 60).astype(np.uint8)])
        plan.append(synth.PlannedPacket(
            channel=36 + i % 7, bits=bits,
            start_sample=(slot * SYMBOLS_PER_SLOT
                          + int(r.integers(0, 400))) * sps))
    x = synth.synthesize_capture(plan, n_samples=30 * SYMBOLS_PER_SLOT * sps,
                                 fs=FS, center_freq=CENTER, noise_std=0.02,
                                 seed=7)
    return np.stack([x.real, x.imag]).astype(np.float32)


def _key(results):
    return [[(h.channel, h.chan_idx, h.clkn, h.sym_offset, h.lap, h.errors,
              h.win_row) for h in r.hits] for r in results]


def _snr(results):
    return [np.array([h.snr_db for h in r.hits]) for r in results]


@pytest.mark.parametrize("wire", ["f32", "i8"])
def test_stream_matches_stream_sync_and_jax(capture, wire, interpret):
    fj = jfrontend.FrontEnd(FS, CENTER, block_slots=8, max_ac_errors=1,
                            use_pallas=True)
    ft = frontend.FrontEnd(FS, CENTER, block_slots=8, max_ac_errors=1,
                           device="cpu")
    ref = list(fj.stream(capture, start_clkn=100, wire=wire))
    got = list(ft.stream(capture, start_clkn=100, wire=wire))
    assert len(got) == len(ref) == 4
    assert _key(got) == _key(ref)
    assert sum(map(len, _key(got))) >= 15
    for a, b in zip(_snr(got), _snr(ref)):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    for rg, rr in zip(got, ref):
        assert [r.slot_base for r in (rg, rr)] == [rr.slot_base] * 2
        for hg, hr in zip(rg.hits, rr.hits):
            assert np.array_equal(ft.packet_symbols(rg, hg),
                                  fj.packet_symbols(rr, hr))
        sg, ng = ft.packet_symbols_matrix(rg)
        sr, nr = fj.packet_symbols_matrix(rr)
        assert np.array_equal(sg, sr) and np.array_equal(ng, nr)
    if wire == "f32":
        # the flat chain on the same samples: here too every window and
        # every hit is identical
        sync = list(ft.stream_sync(capture, start_clkn=100))
        assert _key(sync) == _key(got)
        for a, b in zip(sync, got):
            assert np.array_equal(a.windows, b.windows)
            np.testing.assert_allclose(a.snr_db, b.snr_db, atol=1e-4,
                                       rtol=0)


def test_lap_survey_matches_jax(capture, interpret):
    sj = jlap_survey.LapSurvey(FS, CENTER, block_slots=8, use_pallas=True)
    st = lap_survey.LapSurvey(FS, CENTER, block_slots=8, device="cpu")
    oj = sj.run(capture, start_clkn=5, emit_console=False)
    ot = st.run(capture, start_clkn=5, emit_console=False)
    assert [(o.clkn, o.channel, o.lap, o.errors) for o in ot] == \
        [(o.clkn, o.channel, o.lap, o.errors) for o in oj]
    np.testing.assert_allclose([o.snr_db for o in ot],
                               [o.snr_db for o in oj], atol=1e-3, rtol=0)
    assert st.laps() == sj.laps() == set(LAPS)
