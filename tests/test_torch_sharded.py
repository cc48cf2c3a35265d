"""The port's time-sharded front end (parallel/sharded.py) against the
port's FrontEnd.stream and the JAX package's ShardedFrontEnd.

Four shards on the CPU ([cpu] * 4) over test_sharded.py's capture (8 Msps,
16-slot blocks, a classic piconet and an LE advertising packet in the
second superblock): the classic and LE hits equal, exactly, those of
FrontEnd.stream and of the JAX ShardedFrontEnd on its 4-device mesh,
shard- and superblock-boundary packets included.  device_put_local in
one process equals device_put; the efficiency harness and the dry run
report their figures.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gr_bluetooth_tpu.models.frontend import FrontEnd as JFrontEnd
from gr_bluetooth_tpu.parallel.sharded import ShardedFrontEnd as JSharded
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.parallel import dryrun
from gr_bluetooth_tpu_torch.parallel.sharded import (
    ShardedFrontEnd, measure_scaling_efficiency)
from gr_bluetooth_tpu_torch.parallel.worker import hit_keys
from test_sharded import _capture_with_le
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS, CENTER = 8e6, 2441e6
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def capture():
    fe = FrontEnd(FS, CENTER, block_slots=16, enable_le=True, device="cpu")
    n_slots = fe.block_slots * 4 * 2 + 8    # 136 slots
    samples, _, le_slot = _capture_with_le(n_slots)
    return fe, samples, le_slot


def _hit_sets(results):
    classic = {(h.clkn, h.channel, h.lap) for r in results for h in r.hits}
    le = {(h.clkn, h.channel) for r in results for h in r.le_hits}
    return classic, le


def test_sharded_hits_match_stream_and_jax(capture):
    fe, samples, le_slot = capture
    sfe = ShardedFrontEnd(fe, CPU4)
    assert sfe.with_le and sfe.n_dev == 4
    got = sfe.process(samples)
    assert len(got) == 12                       # 3 superblocks x 4 shards
    classic, le = _hit_sets(got)
    assert (classic, le) == _hit_sets(list(fe.stream(samples)))
    assert classic and any(clkn == le_slot for clkn, _ in le)
    boundary = fe.block_slots * 4               # the superblock boundary
    assert any(boundary - 1 <= clkn <= boundary + 1
               for clkn, _, _ in classic)

    jfe = JFrontEnd(FS, CENTER, block_slots=16, enable_le=True)
    jsfe = JSharded(jfe, Mesh(np.array(jax.devices()[:4]), ("time",)))
    want = jsfe.process(samples)
    # the same hits, block by block and in order
    assert [hit_keys([r]) for r in got] == [hit_keys([r]) for r in want]
    for a, b in zip(got, want):
        assert a.slot_base == b.slot_base
        np.testing.assert_allclose(a.snr_db, b.snr_db, atol=1e-3)


def test_sharded_conv_bank_at_an_odd_rate():
    """At odd rates every shard runs the conv bank's step."""
    fe = FrontEnd(5e6, 2441e6, block_slots=8, device="cpu")
    from gr_bluetooth_tpu_torch.testing import (PiconetSim,
                                                make_piconet_capture)
    sim = PiconetSim(lap=0x24D952, uap=0x47, clk0=0x12780)
    x, _ = make_piconet_capture(sim, n_slots=72, fs=5e6, center_freq=2441e6,
                                seed=4, tx_slots=range(0, 66))
    sfe = ShardedFrontEnd(fe, [torch.device("cpu")] * 2)
    got = sfe.process(x)
    assert hit_keys(got)[0] == hit_keys(list(fe.stream(x)))[0]
    assert hit_keys(got)[0]


def test_device_put_local_equals_device_put():
    fe = FrontEnd(4e6, CENTER, block_slots=8, device="cpu")
    sfe = ShardedFrontEnd(fe, CPU4)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, sfe.total_samples)).astype(np.float32) * 0.1
    head = rng.standard_normal((2, sfe.overlap_samples)).astype(
        np.float32) * 0.1
    out_a = sfe.step(sfe.device_put(x), head)
    out_b = sfe.step(sfe.device_put_local(x), head)
    assert len(out_a) == 4 and out_a[0].shape[0] == 4
    for a, b in zip(out_a, out_b):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sfe.device_put_local(x[:, :-1])


def test_shard_devices_are_checked():
    fe = FrontEnd(4e6, CENTER, block_slots=8, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        ShardedFrontEnd(fe, [])
    with pytest.raises(ValueError, match="all be CUDA or all CPU"):
        ShardedFrontEnd(fe, ["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="halo"):
        ShardedFrontEnd(FrontEnd(4e6, CENTER, block_slots=2, device="cpu"),
                        CPU4)


def test_scaling_efficiency_harness():
    """The harness runs and reports a sane ratio; on the CPU the shards
    share the host's cores, so only sanity-bound it."""
    fe = FrontEnd(4e6, CENTER, block_slots=8, device="cpu")
    eff = measure_scaling_efficiency(fe, CPU4, n_superblocks=2, repeats=5)
    assert eff["n_devices"] == 4 and eff["repeats"] == 5
    assert eff["sharded_sps"] > 0 and eff["ideal_sps"] > 0
    assert eff["scan_1dev_sps"] > 0
    assert eff["halo_bytes_per_superblock"] == \
        2 * fe.overlap_samples * 4 * 4
    assert 0.05 < eff["efficiency"]
    assert eff["efficiency"] <= 1.02 or eff["noise_floor"], eff


def test_dryrun_multichip_prints_its_json(capsys):
    import json
    report = dryrun.dryrun_multichip(4, devices=CPU4, bench=(4e6, 8))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(report))
    for key in ("scaling_efficiency", "efficiency_spread_q",
                "halo_cost_ms", "noise_floor", "sharded_sps",
                "speedup_vs_scan_1dev", "bench_shaped", "n_devices"):
        assert key in printed
    assert printed["n_devices"] == 4
    assert printed["devices"] == ["cpu"] * 4
