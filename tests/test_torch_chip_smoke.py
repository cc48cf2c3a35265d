"""chip_smoke.py's own logic, rehearsed on the CPU at a small size.

The script runs only on a CUDA card; here its planted-capture generator,
its survey check and its conv1d yardstick run against the port's plain
versions, and the script itself must refuse to run without a card (and
outside a checkout) without printing a result.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
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
