"""gps-sdr-sim-torch: the GPS L1 C/A synthesizer on PyTorch and CUDA.

A port of gps_sdr_sim_tpu (JAX/Pallas) to NVIDIA Hopper GPUs. The JAX
package stays the reference; each module here is checked against its
counterpart byte for byte.

Copied, with only their import paths changed (the output bytes depend on
their float64 arithmetic, which stays as it is): constants.py, utils/
(coord, cstd, gpstime), models/ (scenario, orbits, observables, nav
message), ops/plan.py (epoch planning and the [B, C, 12] int32 wire) and
ops/tables.py (sin/cos table). tests/test_torch_hostlayer.py holds the
copy to the original.

Ported (same module names): ops/synth.py + ops/synth_cuda.py +
csrc/synth.cu (the fused Pallas synthesis kernel and its rebase prologue,
as one hand-written sm_90a CUDA kernel with three output modes, each with
its plain PyTorch version), ops/quantize.py, parallel/ (mesh, sharded
synthesis, shard files), runner.py and cli.py. receiver/ is the software
receiver: FFT acquisition and DLL/PLL tracking in torch on the card, and
the JAX package's NumPy decode, PVT, RINEX and RTK modules copied with only
their import paths changed. testing.py holds the golden criterion and the
receiver's tolerances for tests and chip_smoke.py.

This package imports neither JAX nor gps_sdr_sim_tpu: the machine with
the card has no JAX.
"""

__version__ = "0.1.0"
