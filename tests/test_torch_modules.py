"""Every module of the JAX package has a counterpart in the port.

A module of gps_sdr_sim_tpu/ is matched by the file of the same relative
path in gps_sdr_sim_tpu_torch/, or by the files REPLACED names, or stands
in EXEMPT with the reason it has none. A module added to the JAX package
without one fails here. The port's receiver exports the JAX receiver's
names, in its order."""

import pytest

import gps_sdr_sim_tpu.receiver as jax_receiver
from gps_sdr_sim_tpu_torch import receiver
from gps_sdr_sim_tpu_torch.testing import ROOT

JAX_PKG = ROOT / "gps_sdr_sim_tpu"
PORT = ROOT / "gps_sdr_sim_tpu_torch"

# JAX module -> the port's files that take its place.
REPLACED = {
    # The closed form on the host-rebased DeviceBatch (impl xla / closed).
    "ops/synth_jnp.py": ["ops/synth_closed.py"],
    # The Pallas kernels: the wrappers and plain versions, the ctypes
    # binding, and the hand-written CUDA source.
    "ops/synth_pallas.py": ["ops/synth.py", "ops/synth_cuda.py",
                            "csrc/synth.cu"],
}

# JAX module -> why the port has no counterpart.
EXEMPT = {
    "receiver/device.py": (
        "probes in a subprocess whether the backend has complex64 and pins "
        "the receiver to the host CPU if not: a fallback that hides the "
        "device; CUDA and the CPU both have complex64, where the JAX CLI "
        "takes acquire, as the port's CLI does"),
    "utils/compcache.py": (
        "JAX's persistent compilation cache; the port builds its kernels "
        "with nvcc at first use into libraries named by their sources' "
        "hash (ops/synth_cuda.py library_path)"),
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_the_walk_sees_the_whole_package():
    mods = _jax_modules()
    assert len(mods) > 40
    assert {"receiver/acquire_mxu.py", *REPLACED, *EXEMPT} <= set(mods)


@pytest.mark.parametrize("name", _jax_modules())
def test_jax_module_has_a_counterpart(name):
    if name in EXEMPT:
        assert not (PORT / name).exists(), \
            f"{name} has a counterpart now: drop its exemption"
        return
    want = REPLACED.get(name, [name])
    missing = [f for f in want if not (PORT / f).is_file()]
    assert not missing, f"{name}: the port lacks {missing}"


def test_receiver_exports_jaxs_names():
    assert receiver.__all__ == jax_receiver.__all__
    assert all(callable(getattr(receiver, n)) for n in receiver.__all__)
