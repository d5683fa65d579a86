"""Measurement tools of the port: the kernel A/B harness (ab_kernel) and the
int32 throughput microbenchmark (vpu_peak). Run each with python -m.
card holds the card's name line and the timer they share."""
