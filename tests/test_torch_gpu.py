"""The hand-written CUDA kernel against its plain PyTorch version.

Needs a CUDA device (a CUDA kernel has no CPU mode), so it skips here.
This file imports no JAX, so on a machine without JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`
(tests/conftest.py imports JAX)."""

import io

import pytest
import torch

from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.runner import run_simulation
from gps_sdr_sim_tpu_torch.testing import golden_scenario, random_wire


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [16, 8, 1])
def test_cuda_kernel_matches_plain_version(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    for seed in range(4):
        wire, ca, n_chan = random_wire(seed, n_epochs=3, max_gain=400)
        w, c = torch.from_numpy(wire).to(dev), torch.from_numpy(ca).to(dev)
        before = synth.launch_counts["synth_wire"]
        got = synth.synth_wire(w, c, n_chan, 5000, fmt)
        assert synth.launch_counts["synth_wire"] == before + 1
        want = synth.synth_wire_ref(w, c, n_chan, 5000, fmt)
        assert torch.equal(got, want), seed


@pytest.mark.gpu
def test_runner_on_a_card_other_than_the_current_one():
    """cuda:N with N > 0: staging, kernel and readback all go to that card's
    stream, and the writer waits for it, so the bytes equal the CPU run's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    out = {}
    for impl, device in (("cuda", dev), ("torch", "cpu")):
        buf = io.BytesIO()
        run_simulation(golden_scenario("static16"), buf, batch_epochs=1,
                       log=lambda s: None, impl=impl, device=device)
        out[impl] = buf.getvalue()
    assert torch.cuda.current_device() == 0
    assert out["cuda"] == out["torch"]
