"""The plain reference that the benchmark holds the port's bytes to.

It imports neither JAX, nor gps_sdr_sim_tpu, nor anything of
gps_sdr_sim_tpu_torch, and takes nothing that the port made.

The host layer (constants, coord, cstd, gpstime, antenna, atmosphere,
cacode, ephemeris, navmsg, observables, orbit, trajectory, scenario, tables,
and plan's plan_epochs) is a frozen copy of the port's NumPy host layer
(itself a copy of the JAX package's), with only its import paths changed,
SUBBLOCK fixed at its default of 2048, and plan.py cut to plan_epochs. It
works the scenario out again from the configuration's RINEX file and its
trajectory or position. synth.py states the synthesis that the port's
kernels compute, in plain torch int64 arithmetic, one (sample, channel) at
a time, and its quantization to SC16. A later change to the port cannot
move either.
"""
