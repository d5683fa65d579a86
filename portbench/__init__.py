"""The benchmark of the PyTorch and CUDA port (gps_sdr_sim_tpu_torch).

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on the card and prints
one JSON line. Cells, configurations, traffic mixes and metrics are data:
configs/<config>.json, traffic/<traffic>.json, metrics/<metric>.py and a
driver per kind of traffic, drivers/<driver>.py. The plain reference that
decides `correct` is reference/, which imports nothing of the port.
"""
