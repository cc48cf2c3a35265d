"""The port's btrx against the JAX package's on tests/test_cli.py's
stdin cases: the hopper on a float32 pipe with a pcap out, rtl_sdr's
unsigned bytes (--u8) and the int4-packed wire (-4), and the refusal of
stdin at an off-grid rate (exit 2).

Both CLIs run as subprocesses on the same bytes, the port's with
--device cpu, each on one CPU thread.  They must exit with the same code
and print the same stdout and log lines, and their pcaps must hold the
same frames in the same order (timestamps aside).
"""
import os

import numpy as np
import pytest

from gr_bluetooth_tpu.io.ingest import wire_encode
from gr_bluetooth_tpu.testing import PiconetSim, make_piconet_capture
import chip_smoke
from torch_parity import run_clis, same_cli_output


@pytest.fixture(scope="module")
def capture_bytes():
    sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    x, _ = make_piconet_capture(sim, n_slots=256, fs=8e6,
                                center_freq=2441e6, seed=7)
    return x.astype(np.complex64).tobytes()


def test_cli_hopper_stdin_pcap(capture_bytes, tmp_path):
    pcap = {n: str(tmp_path / f"{n}.pcap") for n in ("jax", "port")}
    runs = run_clis(lambda n: ["-r", "8e6", "-f", "2441e6", "-i", "-",
                               "-l", "24d952", "-p", "-W", pcap[n]],
                    stdin=capture_bytes)
    same_cli_output(runs)
    for n, r in runs.items():
        assert b"wrote" in r.stderr
        assert os.path.getsize(pcap[n]) > 24
        with open(pcap[n], "rb") as f:
            assert f.read(4) == b"\xd4\xc3\xb2\xa1"
    frames = chip_smoke.pcap_frames(pcap["port"])
    assert frames and frames == chip_smoke.pcap_frames(pcap["jax"])
    assert [ln for ln in runs["port"].stderr.decode().splitlines()
            if ln.startswith("wrote")] == \
        [ln for ln in runs["jax"].stderr.decode().splitlines()
         if ln.startswith("wrote")]


def _small_capture(seed):
    sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    x, _ = make_piconet_capture(sim, n_slots=96, fs=4e6,
                                center_freq=2441e6, seed=seed,
                                noise_std=0.02)
    return x


def test_stdin_u8_byte_path():
    x = _small_capture(21)
    inter = np.stack([x.real, x.imag], axis=1).reshape(-1)
    u8 = np.clip(np.round(inter * 127.5 + 127.5), 0, 255).astype(np.uint8)
    runs = run_clis(lambda _: ["-r", "4e6", "-f", "2441e6", "-i", "-",
                               "--u8"], stdin=u8.tobytes())
    t = same_cli_output(runs)
    assert b"24d952" in t.stdout + t.stderr


def test_stdin_i4_byte_path():
    x = _small_capture(22)
    packed = wire_encode(np.stack([x.real, x.imag]).astype(np.float32),
                         "i4")
    runs = run_clis(lambda _: ["-r", "4e6", "-f", "2441e6", "-i", "-", "-4"],
                    stdin=packed.tobytes())
    t = same_cli_output(runs)
    assert b"24d952" in t.stdout + t.stderr


@pytest.mark.parametrize("live", [False, True])
def test_stdin_off_grid_rate_refused(live):
    runs = run_clis(lambda _: ["-r", "2.5e6", "-f", "2441e6", "-i", "-", "-s"]
                    + (["--live"] if live else []), stdin=bytes(4000))
    for r in runs.values():
        assert r.returncode == 2
        assert b"off-grid rate 2.5 Msps is not supported" in r.stderr
    assert runs["port"].stderr == runs["jax"].stderr
