"""chip_smoke.py's own logic, rehearsed on the CPU at a small size.

The script runs only on a CUDA card; here its planted-capture
generators (classic ID packets, and LE advertising packets beside them),
its survey and LE checks, its comparison of the two chains and its conv1d
yardstick run against the port's plain versions, and the script itself
must refuse to run without a card (and outside a checkout) without
printing a result.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.models.lap_survey import LapObservation, LapSurvey
from gr_bluetooth_tpu_torch.ops import pfb_kernel

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def survey_run():
    survey = LapSurvey(8e6, 2441e6, block_slots=8, device="cpu")
    x, planted = chip_smoke.plant_capture(survey.fe, 2, seed=5)
    obs = survey.run(x, emit_console=False)
    return survey, x, planted, obs


def test_planted_capture_is_found(survey_run):
    survey, x, planted, obs = survey_run
    fe = survey.fe
    assert x.shape == (fe.overlap_samples + 2 * fe.step_samples,)
    chans = {ch for _, ch, _ in planted}
    assert chans == set(fe.bank.channels)
    assert len({lap for lap, _, _ in planted}) == len(chip_smoke.LAPS)
    slots = [slot for _, _, slot in planted]
    assert len(slots) > len(set(slots))          # shared slots
    assert chip_smoke.check_survey(obs, planted) == \
        len({(lap, ch) for lap, ch, _ in planted})


def test_check_survey_rejects_wrong_results(survey_run):
    _, _, planted, obs = survey_run
    o = obs[0]
    with pytest.raises(AssertionError, match="not reported"):
        chip_smoke.check_survey(
            [p for p in obs if (p.lap, p.channel) != (o.lap, o.channel)],
            planted)
    with pytest.raises(AssertionError, match="unplanted"):
        chip_smoke.check_survey(
            obs + [LapObservation(o.clkn, o.channel, 0x777777, 0, 20.0)],
            planted)
    with pytest.raises(AssertionError, match="at clkn"):
        chip_smoke.check_survey(
            obs + [LapObservation(o.clkn + 40, o.channel, o.lap, 0, 20.0)],
            planted)


def test_le_adv_frame_equals_the_jax_encoder():
    from gr_bluetooth_tpu.core import packets as jpackets
    for index in (37, 38, 39, 5):
        for pdu_type, payload in ((0, bytes(range(9))), (6, b"\xa5" * 30)):
            assert np.array_equal(
                chip_smoke.le_adv_frame(index, pdu_type, payload),
                jpackets.encode_le_adv(chip_smoke.LE_ADV_AA, index,
                                       pdu_type, payload, crc=False))


@pytest.fixture(scope="module")
def le_run():
    """The flat path's rehearsal: 8 Msps centred on 2426 MHz (LE
    advertising channel 38 on BR channel 24), LE on, three 8-slot blocks
    through stream_sync (flat chain) and stream() (fused chain)."""
    fe = FrontEnd(8e6, 2426e6, block_slots=8, max_ac_errors=1,
                  enable_le=True, device="cpu")
    x, planted, le_planted = chip_smoke.plant_le_capture(fe, 3,
                                                         le_per_block=2)
    return (fe, x, planted, le_planted, list(fe.stream_sync(x)),
            list(fe.stream(x)))


def test_le_planted_capture_is_found(le_run):
    fe, x, planted, le_planted, flat, fused = le_run
    assert x.shape == (3 * fe.step_samples,)
    assert len(flat) == len(fused) == 3
    assert {(i, ch) for i, ch, _ in le_planted} == {(38, 24)}
    assert len(le_planted) >= 3
    for res in (flat, fused):
        chip_smoke.check_survey([h for r in res for h in r.hits], planted)
        assert chip_smoke.check_le([h for r in res for h in r.le_hits],
                                   le_planted) == len(le_planted)
    d_snr, d_sym, n_sym = chip_smoke.compare_chains(fe, flat, fused,
                                                    x.shape[0])
    assert d_snr <= 1e-3 and n_sym > 10000 and d_sym <= n_sym * 1e-5


def test_capture_symbols_stop_before_the_padding(le_run):
    """Blocks inside the capture compare every symbol; the last block,
    zero-padded past the capture, only whole timing groups before it."""
    fe, x, *_ = le_run
    n = [chip_smoke.capture_symbols(fe, x.shape[0], i) for i in range(3)]
    assert n[0] == n[1] == fe.n_sym
    assert n[2] % 512 == 0
    delay = (fe.bank.ntaps + 2 * fe.bank.sps) / fe.bank.sps
    assert 0 < (x.shape[0] - 2 * fe.step_samples) / fe.bank.sps - n[2] \
        < 512 + delay + 1
    assert chip_smoke.capture_symbols(fe, None, 2) == fe.n_sym


def test_check_le_rejects_wrong_results(le_run):
    _, _, _, le_planted, flat, _ = le_run
    hits = [h for r in flat for h in r.le_hits]
    adv = [h for h in hits if h.index == 38]
    with pytest.raises(AssertionError, match="not reported"):
        chip_smoke.check_le([h for h in hits if h is not adv[0]],
                            le_planted)
    with pytest.raises(AssertionError, match="unplanted"):
        chip_smoke.check_le(hits + [dataclasses.replace(adv[0],
                                                        clkn=adv[0].clkn + 90)],
                            le_planted)


def test_compare_chains_rejects_differing_hits(le_run):
    fe, _, _, _, flat, fused = le_run
    bad = [dataclasses.replace(fused[0], le_hits=fused[0].le_hits[1:])] + \
        fused[1:]
    with pytest.raises(AssertionError, match="LE hits differ"):
        chip_smoke.compare_chains(fe, flat, bad)
    bad = [dataclasses.replace(fused[0], snr_db=fused[0].snr_db + 0.01)] + \
        fused[1:]
    with pytest.raises(AssertionError, match="SNR"):
        chip_smoke.compare_chains(fe, flat, bad)


def test_conv_yardstick_computes_the_channel_streams():
    """The cuDNN conv1d yardstick is the same function as pfb_snr's y
    (before the (-1)^{cn} rotator), checked with torch's CPU conv."""
    from gr_bluetooth_tpu_torch.ops import pfb
    b = pfb.make_pfb_bank(8e6, 2441e6)
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(0, 0.3, (2, 20000)).astype(np.float32))
    bank = tuple(torch.from_numpy(a.copy()) for a in
                 (b.h0, b.h1, b.dft_c, b.dft_s, b.bin_odd))
    Q, D = b.h0.shape
    n = x.shape[1] // D - 2 * Q
    yr, yi, _ = pfb_kernel.pfb_snr(x, *bank, -(-n // 50) * 50)
    ly = torch.nn.functional.conv1d(
        x[None], chip_smoke.conv_bank_weights(*bank[:4]), stride=D)[0]
    C = bank[2].shape[1]
    sign = 1.0 - 2.0 * (bank[4][:, None] * (torch.arange(n) & 1))
    torch.testing.assert_close(ly[:C, :n] * sign, yr[:, :n], atol=2e-5,
                               rtol=0)
    torch.testing.assert_close(ly[C:, :n] * sign, yi[:, :n], atol=2e-5,
                               rtol=0)


def _run(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    p = _run(ROOT, ROOT / "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and '"kernels"' not in p.stdout


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and '"kernels"' not in p.stdout
