"""Multi-device and multi-process front ends — the port of
gr_bluetooth_tpu/parallel: time shards with a halo (sharded), time x
channel-group grids (sharded2d), the dry run (dryrun) and the
multi-process worker (worker)."""
from .sharded import ShardedFrontEnd, measure_scaling_efficiency
from .sharded2d import Sharded2DFrontEnd

__all__ = ["ShardedFrontEnd", "Sharded2DFrontEnd",
           "measure_scaling_efficiency"]
