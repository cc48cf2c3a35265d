"""chip_smoke.py's phase 8 (the CLI on stdin, the off-grid sniffer and
the multiprocess host decode), rehearsed on the CPU at 8 and 7.68 Msps
with the port's plain versions: the same checks the card run makes, on
small captures, and their refusal of wrong results."""
import numpy as np
import pytest

import chip_smoke
from gr_bluetooth_tpu_torch import testing
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.utils.log import EventBus
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

SIM = testing.PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)


@pytest.fixture(scope="module")
def piconet():
    x, sent = testing.make_piconet_capture(SIM, n_slots=256, fs=8e6,
                                           center_freq=2441e6, seed=7)
    return x, [(s, ch, SIM.lap, t) for s, ch, t in sent]


def test_cli_phase_on_the_cpu(piconet, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the btrx subprocesses
    x, sent = piconet
    out = chip_smoke.cli_phase(x, sent, [SIM], device="cpu", n_min=5,
                               fs=8e6)
    assert out["overruns"] == 0 and out["cli_sps"] > 0


def test_frame_and_slot_checks_reject_wrong_results(piconet):
    _, sent = piconet
    slot, ch, lap, t = sent[0]
    body = bytes(4) + bytes([ch, 1, t << 3]) + bytes(2)
    dst = ((SIM.uap << 24) | lap).to_bytes(6, "big")
    good = (len(body) + 14, dst + bytes(6) + b"\xff\xf0" + body)
    assert chip_smoke.frames_decoded([good]) == [(lap, SIM.uap, t, ch)]
    assert chip_smoke.check_cli_frames([good], sent, [SIM], 1) == 1
    bad_uap = (good[0], ((0x48 << 24) | lap).to_bytes(6, "big") + good[1][6:])
    with pytest.raises(AssertionError, match="unplanted"):
        chip_smoke.check_cli_frames([bad_uap], sent, [SIM], 1)
    with pytest.raises(AssertionError):
        chip_smoke.check_cli_frames([good], sent, [SIM], 2)
    shift = chip_smoke.LOOKAHEAD
    assert chip_smoke.check_air_slots([(slot + shift, ch, lap, "DM1")],
                                      sent, [SIM]) == (1, 1)
    with pytest.raises(AssertionError, match="air slot"):
        chip_smoke.check_air_slots([(slot + shift + 1, ch, lap, "DM1")],
                                   sent, [SIM])
    # one slot early after a slip is allowed only with slack
    assert chip_smoke.check_air_slots([(slot + shift - 1, ch, lap, "DM1")],
                                      sent, [SIM], slack=1) == (1, 0)
    assert chip_smoke.logged_packets(
        b"2026-01-01 00:00:00,000 grbt.sniffer INFO time     12 ch 39 LAP "
        b"24d952 DM1 | LLID: 2\nother\n") == [(12, 39, 0x24D952, "DM1")]


def test_stdin_chunks_pad_with_the_zero_byte():
    inter = np.arange(10, dtype=np.uint8).reshape(5, 2)
    chunks = list(chip_smoke.stdin_chunks(inter, 2, "u8"))
    assert [c.shape for c in chunks] == [(2, 2)] * 3
    assert chunks[-1].tolist() == [[8, 9], [127, 127]]


def test_offgrid_phase_on_the_cpu():
    chip_smoke.offgrid_phase(7.68e6, n_slots=96, device="cpu")


def test_pool_phase_on_the_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the spawned workers
    sims = [testing.PiconetSim(lap=lap, uap=uap, clk0=0x100 * (i + 3))
            for i, (lap, uap) in enumerate([(0x24D952, 0x47),
                                            (0x1A2B3C, 0x99)])]
    samples, _ = testing.make_multi_piconet_capture(
        sims, n_slots=48, fs=4e6, center_freq=2441e6, seed=7,
        noise_std=0.02)
    sn = Sniffer(4e6, 2441e6, block_slots=16, enable_le=False,
                 bus=EventBus(), device="cpu")
    blocks = list(sn.fe.stream(samples))
    out = chip_smoke.pool_phase({"multi": blocks}, sn.fe, n_workers=2)
    assert set(out) == {"multi"} and len(out["multi"]) == 3
    assert all(v > 0 for v in out["multi"])
