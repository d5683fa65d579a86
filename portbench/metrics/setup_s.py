"""setup_s (s): from the start of the benchmark's process to the first
timed batch: importing PyTorch and the port, building the scenario, loading
(or, in a fresh checkout, building) the kernel's library, building the mesh
and the warm-up."""


def read(run):
    return run.setup_s
