"""Parallel layer of the port.

Counterpart of gps_sdr_sim_tpu/parallel: time-block and channel sharding of
the IQ synthesis (the wire kernel, the row kernel and the closed form) over
a mesh of torch devices, with the chan axis's raw int32 partial sums added
before quantization, plus per-process ordered shard files with a manifest
for multi-process output and restart/resume.
"""

from gps_sdr_sim_tpu_torch.parallel.mesh import auto_mesh, make_mesh
from gps_sdr_sim_tpu_torch.parallel.shard import (
    synth_batch_sharded,
    synth_epochs_sharded,
    synth_rows_sharded,
)
from gps_sdr_sim_tpu_torch.parallel.writer import (
    Manifest,
    concat_shards,
    plan_epoch_shards,
    run_simulation_sharded,
)

__all__ = [
    "auto_mesh",
    "make_mesh",
    "synth_batch_sharded",
    "synth_epochs_sharded",
    "synth_rows_sharded",
    "Manifest",
    "concat_shards",
    "plan_epoch_shards",
    "run_simulation_sharded",
]
