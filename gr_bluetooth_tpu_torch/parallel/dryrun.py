"""Multi-device dry run: the port's twin of the JAX package's
__graft_entry__.py:dryrun_multichip.

    python -c "from gr_bluetooth_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; import torch; \\
        dryrun_multichip(4, [torch.device('cpu')] * 4)"

It runs the 4 Msps LE-on sharded step and a two-superblock stream, a
(n/2, 2) time x channel-group grid when n is even, and
measure_scaling_efficiency at the toy shape and at the bench shape
(16 Msps, 64-slot blocks by default), and prints the JSON the JAX dry
run prints, with the shards' devices.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..models.frontend import FrontEnd
from .sharded import ShardedFrontEnd, as_devices, measure_scaling_efficiency
from .sharded2d import Sharded2DFrontEnd

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int, devices=None,
                     bench=(16e6, 64)) -> dict:
    """Dry run over n_devices shards.  `devices` lists one device per
    shard (on one card, [cuda:0] * n); without it every shard needs a
    card of its own, and fewer cards raise.  `bench` is the bench-shaped
    point's (sample rate, block_slots).  Returns the printed report."""
    if devices is None:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have "
                               f"{have}; pass devices= to put several "
                               f"shards on one device")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devs = as_devices(devices)
    if len(devs) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devs)}")
    # tiny shapes: 4 Msps, 8-slot chunks per shard; LE path included so
    # the dry run covers the full sniffer-grade sharded step
    fe = FrontEnd(4e6, 2441e6, block_slots=8, enable_le=True,
                  device=devs[0])
    sfe = ShardedFrontEnd(fe, devs)
    x = np.zeros((2, sfe.total_samples), dtype=np.float32)
    head = np.zeros((2, sfe.overlap_samples), dtype=np.float32)
    out = sfe.step(sfe.device_put(x), head)
    snr_db, n_hits, tab, windows, n_le, le_tab, le_windows = out
    assert snr_db.shape[0] == n_devices and tab.shape[0] == n_devices
    assert le_tab.shape[0] == n_devices
    # multi-step stream: two superblocks, a real inter-step halo
    results = sfe.process(np.zeros((2, 2 * sfe.total_samples), np.float32))
    assert len(results) == 2 * n_devices

    # 2-D grid (time x channel group): per-shard work = one time chunk of
    # one contiguous channel group; the host merges per-group hit tables
    if n_devices % 2 == 0:
        grid = [devs[2 * t: 2 * t + 2] for t in range(n_devices // 2)]
        sfe2 = Sharded2DFrontEnd(fe, grid)
        res2 = sfe2.process(np.zeros((2, sfe2.total_samples), np.float32))
        assert len(res2) == n_devices // 2
        assert res2[0].snr_db.shape[1] == fe.bank.n_channels
    # scaling-efficiency figures: `efficiency` isolates the halo exchange
    # (sharded step vs the same shards with pre-placed halos);
    # `speedup_vs_scan_1dev` is sharded vs a one-device loop over the
    # same superblock.  Measured at the toy shape AND at a bench-shaped
    # operating point (64-slot chunks, 16 Msps)
    eff = measure_scaling_efficiency(fe, devs, n_superblocks=4, repeats=5)
    fe_bench = FrontEnd(bench[0], 2441e6, block_slots=bench[1],
                        enable_le=True, device=devs[0])
    eff_b = measure_scaling_efficiency(fe_bench, devs, n_superblocks=2,
                                       repeats=5)

    def fmt(e):
        return {
            "scaling_efficiency": round(e["efficiency"], 3),
            "efficiency_spread_q": [round(e["efficiency_q25"], 3),
                                    round(e["efficiency_q75"], 3)],
            "efficiency_spread": [round(e["efficiency_min"], 3),
                                  round(e["efficiency_max"], 3)],
            "repeats": e["repeats"],
            "halo_cost_ms": round(e["halo_cost_ms"], 2),
            "timer_jitter_ms": round(e["timer_jitter_ms"], 2),
            "halo_bytes_per_superblock": e["halo_bytes_per_superblock"],
            "noise_floor": e["noise_floor"],
            "sharded_sps": round(e["sharded_sps"], 1),
            "ideal_sps": round(e["ideal_sps"], 1),
            "speedup_vs_scan_1dev": round(e["speedup_vs_scan_1dev"], 3),
        }

    report = {
        **fmt(eff),
        "n_devices": eff["n_devices"],
        "bench_shaped": {"fs": bench[0], "block_slots": bench[1],
                         **fmt(eff_b)},
        "devices": [str(d) for d in devs],
        "note": ("efficiency = median sharded/ideal-twin ratio; the TRUE "
                 "ratio is in (0, 1], measured per-repeat quotients can "
                 "exceed 1 under timer jitter (spread_q = interquartile); "
                 "noise_floor flags halo cost below jitter")}
    print(json.dumps(report))
    return report
