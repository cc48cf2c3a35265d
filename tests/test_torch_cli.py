"""The port's btrx against the JAX package's, on tests/test_cli.py's
file, synthetic and argument cases (the stdin cases are in
tests/test_torch_cli_stdin.py, so that `--dist loadfile` spreads the two
files over two workers).

Both CLIs run as subprocesses on the same input, the port's with
--device cpu, each on one CPU thread.  They must exit with the same code
and print the same stdout (LAP, UAP and clock lines) and the same log
lines (decoded packets, discovery), and the messages the JAX test checks.
"""
import contextlib
import io

import numpy as np
import pytest

from gr_bluetooth_tpu.testing import PiconetSim, make_piconet_capture
from gr_bluetooth_tpu_torch.apps import btrx
from torch_parity import log_lines, run_clis, same_cli_output


@pytest.fixture(scope="module")
def capture_file(tmp_path_factory):
    sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    x, _ = make_piconet_capture(sim, n_slots=256, fs=8e6,
                                center_freq=2441e6, seed=7)
    p = tmp_path_factory.mktemp("caps") / "cap.cfile"
    x.astype(np.complex64).tofile(p)
    return str(p)


def test_cli_requires_rate():
    runs = run_clis(lambda _: ["-r", "1e6"])
    for r in runs.values():
        assert r.returncode == 1
        assert b"below minimum" in r.stderr
    assert runs["port"].stderr == runs["jax"].stderr


def test_cli_lap_survey_synthetic():
    runs = run_clis(lambda _: ["-r", "8e6", "-f", "2441e6", "--synthetic",
                               "128"])
    t = same_cli_output(runs)
    assert b"LAP 24d952" in t.stdout


def test_cli_uap_from_file(capture_file):
    runs = run_clis(lambda _: ["-r", "8e6", "-f", "2441e6", "-i",
                               capture_file, "-l", "24d952"])
    t = same_cli_output(runs)
    assert b"UAP = 0x47" in t.stdout


def test_cli_checkpoint_resume_stats(capture_file, tmp_path):
    ck = {n: str(tmp_path / f"{n}.npz") for n in ("jax", "port")}
    runs = run_clis(lambda n: ["-r", "8e6", "-f", "2441e6", "-i",
                               capture_file, "-S", "--no-le",
                               "--checkpoint", ck[n], "--stats"])
    t = same_cli_output(runs)
    assert any("LAP 24d952" in s for s in log_lines(t.stderr))
    for n, r in runs.items():
        assert b"checkpointed to" in r.stderr
        assert b"stage device_step" in r.stderr     # --stats report
    # the two checkpoints hold the same piconet state and cursor
    a, b = np.load(ck["jax"]), np.load(ck["port"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
    # each resumes from its own checkpoint and decodes the same packets
    runs = run_clis(lambda n: ["-r", "8e6", "-f", "2441e6", "-i",
                               capture_file, "-S", "--no-le",
                               "--resume", ck[n]])
    t = same_cli_output(runs)
    for r in runs.values():
        assert b"resumed from" in r.stderr


def test_cli_without_a_card_or_device_exits(monkeypatch):
    """With no --device the port runs on the card; without one it exits
    non-zero with resolve_device's message, before any work."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stderr(out):
        rc = btrx.main(["-r", "8e6", "-f", "2441e6", "--synthetic", "16"])
    assert rc == 1
    assert "no CUDA device is available" in out.getvalue()
