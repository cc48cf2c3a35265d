"""The port's multi-process sharded stream: two OS processes under a
torch.distributed gloo process group, 2 CPU shards each, each placing
its own contiguous half of every superblock (device_put_local), the halo
between them sent point to point through host memory.  Process 0's
assembled hits equal the single-process 4-shard run's and the JAX
ShardedFrontEnd's on its 4-device mesh, exactly.  The worker processes
import the port only (gr_bluetooth_tpu_torch.parallel.worker), no JAX.
"""
import os

import jax
import numpy as np
import torch
from jax.sharding import Mesh

from gr_bluetooth_tpu.models.frontend import FrontEnd as JFrontEnd
from gr_bluetooth_tpu.parallel.sharded import ShardedFrontEnd as JSharded
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.parallel.sharded import ShardedFrontEnd
from gr_bluetooth_tpu_torch.parallel.worker import hit_keys, launch
from test_sharded import _capture_with_le
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS, CENTER, SLOTS = 8e6, 2441e6, 16


def test_two_gloo_processes_match_one_process_and_jax(tmp_path):
    fe = FrontEnd(FS, CENTER, block_slots=SLOTS, enable_le=True,
                  device="cpu")
    n_slots = SLOTS * 4 * 2 + 8
    samples, _, le_slot = _capture_with_le(n_slots)
    x = np.stack([samples.real, samples.imag]).astype(np.float32)
    np.save(tmp_path / "capture.npy", x)
    got = launch(2, str(tmp_path / "capture.npy"), rate=FS,
                 block_slots=SLOTS, shards=2, device="cpu", enable_le=True,
                 timeout=300,
                 env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert got["backend"] == "gloo" and got["blocks"] == 12

    one = hit_keys(ShardedFrontEnd(fe, [torch.device("cpu")] * 4)
                   .process(x))
    jfe = JFrontEnd(FS, CENTER, block_slots=SLOTS, enable_le=True)
    jax_keys = hit_keys(JSharded(jfe, Mesh(np.array(jax.devices()[:4]),
                                           ("time",))).process(x))
    assert (got["hits"], got["le_hits"]) == one == jax_keys
    assert got["hits"] and any(h[2] == le_slot for h in got["le_hits"])
