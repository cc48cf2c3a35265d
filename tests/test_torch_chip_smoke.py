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
from gr_bluetooth_tpu_torch import bench
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.models.lap_survey import LapObservation, LapSurvey
from gr_bluetooth_tpu_torch.ops import pfb_kernel
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

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


def test_dense_detector_check():
    """Phase 3c's check on the CPU: the dense entry points against their
    plain versions (here the same) and against detect_words' hit plane,
    on bits with access codes planted at the first and last offsets."""
    from gr_bluetooth_tpu_torch.core.access_code import ac_bits
    from gr_bluetooth_tpu_torch.ops import detect_kernel
    r = np.random.default_rng(11)
    C, T = 6, 3000
    bits = r.integers(0, 2, (C, T))
    for c, off in ((0, 0), (3, 1500), (5, T - 72)):
        bits[c, off:off + 68] = ac_bits(0x24D952 + c)[:68]
    words = detect_kernel.pack_bits_words(torch.from_numpy(bits))
    launches, n, n_hits = chip_smoke.dense_detector(
        words, T, torch.from_numpy(detect_kernel.ac_masks()))
    assert (launches, n) == (0, T - 71) and n_hits >= 3


@pytest.fixture(scope="module")
def mode_caps():
    """The modes phase's captures at 8 Msps (7 of the 79 channels)."""
    return chip_smoke.mode_captures(8e6, 2441e6), chip_smoke.piconet_sims()


def test_mode_captures_equal_the_jax_package(mode_caps):
    from gr_bluetooth_tpu import testing as jtesting
    caps, _ = mode_caps
    sims = [jtesting.PiconetSim(lap=lap, uap=uap, clk0=clk0)
            for lap, uap, clk0 in bench.PICONETS]
    want = {"max_rate": jtesting.make_multi_piconet_capture(
                sims, 256, 8e6, 2441e6, seed=13),
            "mixed": jtesting.make_hostile_capture(sims, 256, 8e6, 2441e6,
                                                   seed=13),
            "e2e": jtesting.make_piconet_capture(
                sims[0], 256, 8e6, 2441e6, seed=13, noise_std=0.02,
                tx_slots=range(0, 248, 2))}
    for name, (x, sent) in caps.items():
        assert np.array_equal(x, want[name][0]) and sent == want[name][1]
    assert len(caps["max_rate"][1]) == 250 and len(caps["mixed"][1]) == 101


@pytest.fixture(scope="module")
def sniffed(mode_caps):
    from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
    from gr_bluetooth_tpu_torch.utils.log import EventBus
    caps, sims = mode_caps
    x, sent = caps["max_rate"]
    sn = Sniffer(8e6, 2441e6, bus=EventBus(), device="cpu")
    return sn, sn.run(x), sent, sims


def test_check_sniffer_on_max_rate(sniffed):
    sn, decoded, sent, sims = sniffed
    in_band = [r for r in sent if r[1] in set(sn.fe.bank.channels)]
    assert chip_smoke.check_sniffer(decoded, sn.bus, sent, sims,
                                    len(in_band)) == len(in_band) >= 15


def test_check_sniffer_rejects_wrong_results(sniffed):
    sn, decoded, sent, sims = sniffed
    p = decoded[3]
    cases = {
        "unplanted": [dataclasses.replace(p, clkn=255)],
        "planted": [dataclasses.replace(p, packet_type=4)],
        "twice": [p],
        "at least": [],
    }
    for match, extra in cases.items():
        n = len(decoded) + (1 if match == "at least" else 0)
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_sniffer(decoded + extra, sn.bus, sent, sims, n)
    with pytest.raises(AssertionError, match="UAP|0x"):
        chip_smoke.check_sniffer(decoded + [dataclasses.replace(
            p, clkn=max(r[0] for r in sent) + 1)], sn.bus,
            sent + [(max(r[0] for r in sent) + 1, p.channel, p.lap)],
            [dataclasses.replace(s, uap=s.uap ^ 1) for s in sims], 0)


def test_e2e_checks_and_winnower_replay(mode_caps):
    """UapDiscovery and Hopper (int16 wire) over the e2e capture, the
    Hopper's pattern replayed through DeviceWinnower (here on the CPU
    twice)."""
    from gr_bluetooth_tpu_torch.models.hopper import Hopper
    from gr_bluetooth_tpu_torch.models.uap_discovery import UapDiscovery
    from gr_bluetooth_tpu_torch.utils.log import EventBus
    caps, sims = mode_caps
    x, sent = caps["e2e"]
    ud = UapDiscovery(8e6, 2441e6, lap=sims[0].lap, bus=EventBus(),
                      device="cpu")
    chip_smoke.check_uap(ud, ud.run(x), sent, sims[0])
    hp = Hopper(8e6, 2441e6, lap=sims[0].lap, bus=EventBus(), device="cpu")
    decoded = hp.run_blocks(hp.fe.stream(x, wire="i16"))
    assert chip_smoke.check_hopper(hp, decoded, sims[0]) > \
        hp.piconet.DEVICE_WINNOW_THRESHOLD
    assert chip_smoke.replay_winnower(hp.piconet, "cpu").tolist() == \
        [(sims[0].clk0 + hp.piconet.first_pkt_time) & 0x7FFFFFF]
    with pytest.raises(AssertionError):
        chip_smoke.check_hopper(hp, decoded, dataclasses.replace(
            sims[0], clk0=sims[0].clk0 + 64))


def test_check_le_connection():
    """Phase 7c's check over tests/test_models.py's LE connection capture
    (8 Msps centred on 2426 MHz: advertising channel 38 and data channel
    indices 10 and 11)."""
    from gr_bluetooth_tpu_torch import testing
    from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
    from gr_bluetooth_tpu_torch.utils.log import EventBus
    sim = testing.LeConnectionSim(ch_map=(1 << 10) | (1 << 11),
                                  hop_increment=5, interval=6, win_offset=1)
    x, sent = testing.make_le_connection_capture(sim, n_slots=128, fs=8e6,
                                                 center_freq=2426e6)
    sn = Sniffer(8e6, 2426e6, bus=EventBus(), device="cpu")
    sn.run(x)
    assert chip_smoke.check_le_connection(sn, sim, sent) == \
        sum(1 for *_, kind in sent if kind == "DATA")
    with pytest.raises(AssertionError):
        chip_smoke.check_le_connection(
            sn, dataclasses.replace(sim, crc_init=sim.crc_init ^ 1), sent)
