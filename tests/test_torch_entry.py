"""The port's entry points (gps_sdr_sim_tpu_torch.entry) on the CPU against
the JAX package's __graft_entry__.py.

- entry(device="cpu") plans the same two epochs as the JAX entry() and its
  forward (the closed form in plain torch) gives the JAX forward's I/Q,
  exactly;
- dryrun_multichip(8) on eight entries of the CPU passes every check of
  the JAX checklist, it refuses fewer entries than devices asked for, and
  the module's command line runs both. (A mesh with a chan axis of 3
  raises: test_torch_parallel.py::test_mesh_checks.)"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu_torch import entry as port_entry

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import __graft_entry__ as graft  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run torch on one thread here: the suite runs several test processes
    on a few cores, and these ops stall on contended intra-op threads
    (ROADMAP C3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_jax_entry():
    fn, args = port_entry.entry(device="cpu")
    jax_fn, jax_args = graft.entry()
    assert len(args) == len(jax_args)
    for a, b in zip(args, jax_args):
        assert a.device == CPU
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = fn(*args)
    assert out.dtype == torch.int16 and out.shape == (2, 100000, 2)
    assert int(out.abs().max()) > 0
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jax.jit(jax_fn)(*jax_args)))


def test_dryrun_multichip_8_on_cpu():
    checks = port_entry.dryrun_multichip(8, [CPU] * 8)
    assert checks == ["closed-sharded 4x2 = closed",
                      "row-sharded 8x1 = closed",
                      "row-sharded 4x2 = closed",
                      "wire-sharded 4x2 = wire", "wire = closed"]


def test_dryrun_multichip_refuses_too_few_devices():
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        port_entry.dryrun_multichip(8, [CPU] * 4)


def test_odd_mesh_has_no_chan_axis():
    assert port_entry.dryrun_multichip(3, [CPU] * 3) == [
        "closed-sharded 3x1 = closed", "row-sharded 3x1 = closed",
        "wire-sharded 3x1 = wire", "wire = closed"]


def test_command_line(capsys):
    assert port_entry.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("entry: (2, 100000, 2) torch.int16")
    assert out[1].startswith("dryrun_multichip(8): OK (closed-sharded 4x2")
