"""chip_smoke.py's phase 9, rehearsed on the CPU at a small size: the
Kismet survey and its server and CLI (9a), the time-sharded front end
(9b), the 2 x 2 time x channel-group grid with the group-width kernel
checks (9c) and two gloo processes (9d), each run through the script's
own functions with device="cpu" (8 Msps, 8-slot blocks; 9b to 9d centred
on 2426 MHz, where the band holds LE advertising channel 38), also in
the forms `--cards N` calls them (device lists, a grid, a process per
shard).  Launch counts are read only on a card."""
import numpy as np
import pytest
import torch

import chip_smoke
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS, LE_CENTER, B = 8e6, 2426e6, 8


def test_kismet_phase(monkeypatch):
    # btsurvey runs as a subprocess: one CPU thread, as the other
    # workers of the tier-1 run hold the rest
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    chip_smoke.kismet_phase(FS, 2441e6, block_slots=B, n_blocks=3,
                            device="cpu", cli_slots=128)


@pytest.fixture(scope="module")
def sharded():
    return chip_smoke.sharded_phase(FS, LE_CENTER, block_slots=B,
                                    device="cpu", n_shards=4, n_blocks=8)


def test_sharded_phase_over_a_device_list():
    """--cards' form: one shard per listed device."""
    planes, results = chip_smoke.sharded_phase(
        FS, LE_CENTER, block_slots=B, n_blocks=8,
        devices=[torch.device("cpu")] * 4)
    assert len(results) == 8


def test_sharded_phase(sharded):
    planes, results = sharded
    assert planes.shape == (2, 8 * B * 625 * 8) and len(results) == 8
    # the boundary packets were planted and found (check_survey/check_le
    # inside the phase); the capture has LE hits
    assert any(r.le_hits for r in results)


@pytest.mark.parametrize("grid", [None, [["cpu", "cpu"], ["cpu", "cpu"]]])
def test_grid_phase(grid):
    chip_smoke.grid_phase(FS, LE_CENTER, block_slots=B, device="cpu",
                          n_blocks=4, grid=grid)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_multi_process_phase(sharded, monkeypatch, n_procs):
    """9d (two processes of two shards) and --cards' form (a process
    per shard, "{rank}" in the device), here under gloo on the CPU."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    chip_smoke.two_process_phase(*sharded, fs=FS, center=LE_CENTER,
                                 block_slots=B, device="cpu", n_shards=4,
                                 n_procs=n_procs)


def test_boundary_packets_cross_into_the_next_chunk():
    fe = FrontEnd(FS, LE_CENTER, block_slots=B, enable_le=True,
                  device="cpu")
    _, planted, le_planted = chip_smoke.plant_le_capture(
        fe, 4, seed=6, le_per_block=1, boundary_slots=(B - 1, 2 * B - 1))
    assert planted[:2] == [(chip_smoke.LAPS[0], planted[0][1], B - 1),
                           (chip_smoke.LAPS[1], planted[1][1], 2 * B - 1)]
    assert le_planted[:2] == [(38, 24, B - 1), (38, 24, 2 * B - 1)]
    # without boundary slots the capture is the one phase 5 always had
    x0, p0, l0 = chip_smoke.plant_le_capture(fe, 2)
    x1, p1, l1 = chip_smoke.plant_le_capture(fe, 2, boundary_slots=())
    assert np.array_equal(x0, x1) and (p0, l0) == (p1, l1)
