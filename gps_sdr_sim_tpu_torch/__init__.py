"""gps-sdr-sim-torch: the GPS L1 C/A synthesizer on PyTorch and CUDA.

A port of gps_sdr_sim_tpu (JAX/Pallas) to one NVIDIA Hopper GPU. The JAX
package stays the reference; each module here is checked against its
counterpart byte for byte.

Reused as they are, not copied (they are NumPy and import no JAX):
gps_sdr_sim_tpu.constants, .models (scenario, orbits, observables, nav
message), .utils (coord, cstd, gpstime), .ops.plan (epoch planning and the
[B, C, 12] int32 wire), .ops.tables (sin/cos table), and the JAX-free
helpers of .cli (argument actions, build_config, the JSON summary).

Ported (same module names): ops/synth.py + ops/synth_cuda.py +
csrc/synth.cu (the fused Pallas synthesis kernel and its rebase prologue,
as one hand-written sm_90a CUDA kernel, with its plain PyTorch version),
ops/quantize.py, runner.py and cli.py. testing.py holds the golden
criterion for tests and chip_smoke.py.

This package never imports JAX: the machine with the card has none.
"""

__version__ = "0.1.0"
