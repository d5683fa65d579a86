"""Device mesh for sharded IQ synthesis.

Counterpart of gps_sdr_sim_tpu/parallel/mesh.py. Axes:
  'time' — time-block parallelism: independent 0.1 s epochs (the reference's
           sequential iumd loop, gpssim.c:2154) sharded as pure data
           parallelism; no communication, because phase state is propagated
           analytically on the host (models/scenario.py).
  'chan' — channel parallelism: the per-channel sum (gpssim.c:2195-2209)
           split across devices; partial int32 accumulators are added on
           the time shard's first device before quantization (see
           parallel/shard.py).

Unlike a jax.sharding.Mesh, a grid here may name the same device more than
once. Torch has a single CPU device and nothing like XLA's virtual host
devices, so without repeats neither a CPU test nor a one-card machine could
build a 2x2 mesh; the entries that share a device run one after the other
on its stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from gps_sdr_sim_tpu_torch.constants import MAX_CHAN

TIME_AXIS = "time"
CHAN_AXIS = "chan"


@dataclass(frozen=True)
class Mesh:
    """An n_time x n_chan grid of devices: grid[t][c]."""

    grid: tuple

    @property
    def shape(self) -> dict:
        return {TIME_AXIS: len(self.grid), CHAN_AXIS: len(self.grid[0])}


def local_devices(device_type: str = "cuda") -> list:
    """Every device of `device_type` on this host: all cards for "cuda",
    the one CPU device for "cpu"."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no mesh for device type {device_type!r}")


def make_mesh(n_time: int, n_chan: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build an (n_time, n_chan) mesh over the first n_time*n_chan entries
    of `devices` (default: every card), which may repeat a device.

    The channel axis varies fastest, as in the JAX package."""
    if devices is None:
        devices = local_devices("cuda")
    if n_time < 1 or n_chan < 1:
        raise ValueError(f"mesh ({n_time}x{n_chan}) needs positive axes")
    need = n_time * n_chan
    if len(devices) < need:
        raise ValueError(
            f"mesh ({n_time}x{n_chan}) needs {need} devices, "
            f"have {len(devices)}")
    if MAX_CHAN % n_chan != 0:
        raise ValueError(f"n_chan={n_chan} must divide MAX_CHAN={MAX_CHAN}")
    devs = [torch.device(d) for d in devices[:need]]
    return Mesh(tuple(tuple(devs[t * n_chan:(t + 1) * n_chan])
                      for t in range(n_time)))


def auto_mesh(n_devices: Optional[int] = None, n_chan: int = 1,
              device="cuda") -> Mesh:
    """Mesh over all (or the first n_devices) local devices of `device`'s
    type: every card for cuda, a 1x1 mesh for cpu."""
    devices = local_devices(torch.device(device).type)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % n_chan != 0:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"n_chan={n_chan}")
    return make_mesh(n_devices // n_chan, n_chan, devices[:n_devices])
