"""Tools of the port, each run with python -m: the kernel A/B harness
(ab_kernel), the int32 throughput microbenchmark (vpu_peak), the kernel
cost attribution (profile_kernel) and SASS budget (op_budget), the
benchmark (bench), the scaling sweep (bench_scaling), the day run (dayrun)
with its block sampler (deepcheck), the UHD player (uhd_player), and the
two tools that hold the CLI and the receiver to an oracle: the randomized
CLI matrix (fuzz_oracle) and the static and kinematic RTK closures
(rtk_oracle). card holds the card's name line and the timer they share."""
