"""The port's 2-D (time x channel group) front end (parallel/sharded2d.py)
against the JAX package's Sharded2DFrontEnd.

The groups (starts, valid_start, size, LE row maps) equal the JAX
package's; over test_sharded2d.py's capture (8 Msps, 16-slot blocks, a
hopping piconet and two LE advertising packets in different groups) on
a 4 x 2 grid of CPU shards, the classic and LE hits and the hits'
packet-symbol windows equal the JAX Sharded2DFrontEnd's on its 4 x 2
mesh and the port's FrontEnd.stream, exactly.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gr_bluetooth_tpu.models.frontend import FrontEnd as JFrontEnd
from gr_bluetooth_tpu.parallel.sharded2d import Sharded2DFrontEnd as J2D
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.parallel.sharded2d import Sharded2DFrontEnd
from gr_bluetooth_tpu_torch.parallel.worker import hit_keys
from test_sharded2d import _capture_with_le
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS, CENTER = 8e6, 2441e6
CPU = torch.device("cpu")


def _mesh(t, g):
    return Mesh(np.array(jax.devices()[:t * g]).reshape(t, g),
                ("time", "chan"))


@pytest.mark.parametrize("fs,G", [(8e6, 2), (8e6, 3), (4e6, 3),
                                  (80e6, 2), (80e6, 4)])
def test_groups_equal_jax(fs, G):
    fe = FrontEnd(fs, CENTER, block_slots=8, enable_le=True, device="cpu")
    ours = Sharded2DFrontEnd(fe, [[CPU] * G])
    jfe = JFrontEnd(fs, CENTER, block_slots=8, enable_le=True)
    theirs = J2D(jfe, _mesh(1, G))
    for f in ("group_size", "starts", "valid_start", "le_maps",
              "total_samples", "superblock_slots"):
        assert getattr(ours, f) == getattr(theirs, f), f
    # every channel in exactly one group's valid range
    covered = [c for g in range(G)
               for c in range(ours.starts[g] + ours.valid_start[g],
                              ours.starts[g] + ours.group_size)]
    assert covered == list(range(fe.bank.n_channels))


def test_group_constants_are_the_banks_columns():
    fe = FrontEnd(80e6, CENTER, block_slots=8, enable_le=True, device="cpu")
    s2 = Sharded2DFrontEnd(fe, [[CPU] * 2])
    assert s2.group_size == 40
    for g, col in enumerate(s2.columns):
        c = col.consts[0]
        s = s2.starts[g]
        assert c["dft_c"].shape == (80, 41)
        assert torch.equal(c["dft_c"], fe.consts["dft_c"][:, s:s + 41])
        assert torch.equal(c["bin_odd"], fe.consts["bin_odd"][s:s + 41])
        m = s2.le_maps[g]
        rows = [fe.le_rows[j][0] - s for j in m]
        assert c["le_rows"][:len(m)].tolist() == rows
        assert (c["le_max_dist"][len(m):] == -1).all()


@pytest.fixture(scope="module")
def runs():
    fe = FrontEnd(FS, CENTER, block_slots=16, enable_le=True, device="cpu")
    n_slots = fe.block_slots * 4 * 2 + 8
    samples, _, le_slots = _capture_with_le(n_slots)
    s2 = Sharded2DFrontEnd(fe, [[CPU, CPU]] * 4)
    jfe = JFrontEnd(FS, CENTER, block_slots=16, enable_le=True)
    j2 = J2D(jfe, _mesh(4, 2))
    return (fe, s2, le_slots, s2.process(samples), j2.process(samples),
            list(fe.stream(samples)))


def test_2d_hits_match_jax_and_stream(runs):
    fe, s2, _, got, want, flat = runs
    assert [hit_keys([r]) for r in got] == [hit_keys([r]) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.snr_db, b.snr_db, atol=1e-3)
    ours = hit_keys(got)
    assert ours == hit_keys(flat)
    classic, le = ours
    assert all(s2.le_maps[g] for g in range(2))
    assert len(le) >= 2 and {c[0] for c in le} >= {38, 42}
    boundary = fe.bank.channels[s2.starts[1] + s2.valid_start[1]]
    chans = {c[0] for c in classic}
    assert {c for c in chans if c < boundary} and \
        {c for c in chans if c >= boundary}


def test_2d_windows_match_jax(runs):
    fe, _, _, got, want, flat = runs

    def windows(results):
        return {(h.clkn, h.channel): fe.packet_symbols(r, h)
                for r in results for h in r.hits}

    a, b, c = windows(got), windows(want), windows(flat)
    assert a and set(a) == set(b) == set(c)
    for k in a:
        assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k])
    le_a = [fe.le_packet_symbols(r, h) for r in got for h in r.le_hits]
    le_c = [fe.le_packet_symbols(r, h) for r in flat for h in r.le_hits]
    assert len(le_a) == len(le_c) >= 2
    for x, y in zip(le_a, le_c):
        assert np.array_equal(x, y)
