"""The port's tools and the CLI's --profile on the CPU.

- tools/vpu_peak: the plain version equals the Pallas interpreter run of
  tools/vpu_peak.py::_make_kernel in all five cases, word for word; the
  SASS loop reader finds each case's round loop;
- tools/ab_kernel: the --cpu plumbing at a tiny batch, and the refusal of
  the JAX harness's TPU-only variants;
- --profile: a trace file appears, the bytes equal a run without the flag,
  and stderr's last line equals the JAX CLI's."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gps_sdr_sim_tpu.cli import main as jax_main
from gps_sdr_sim_tpu_torch.cli import main
from gps_sdr_sim_tpu_torch.ops import synth_cuda
from gps_sdr_sim_tpu_torch.testing import ROOT
from gps_sdr_sim_tpu_torch.tools import ab_kernel, card, vpu_peak

from test_torch_runner import STATIC


@pytest.fixture(scope="module")
def jax_vpu_peak():
    """tools/vpu_peak.py as a module; it enables a compilation cache at
    import unless told not to."""
    before = os.environ.get("GPS_SDR_SIM_TPU_NO_CACHE")
    os.environ["GPS_SDR_SIM_TPU_NO_CACHE"] = "1"
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tools_vpu_peak", ROOT / "tools" / "vpu_peak.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if before is None:
            del os.environ["GPS_SDR_SIM_TPU_NO_CACHE"]
        else:
            os.environ["GPS_SDR_SIM_TPU_NO_CACHE"] = before
    return module


@pytest.mark.parametrize("case", sorted(vpu_peak.CASES))
def test_vpu_peak_plain_matches_pallas_interpret(jax_vpu_peak, case):
    tiles, rounds = 2, 3
    _, alu, gathers, extra, n_extra = vpu_peak.CASES[case]
    seed, table = vpu_peak.inputs("cpu")
    kernel = jax_vpu_peak._make_kernel(rounds, gathers, alu, extra, n_extra)
    fn = pl.pallas_call(
        kernel, grid=(tiles,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((16, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((tiles * 16, 128), jnp.int32),
        interpret=True)
    want = np.asarray(fn(jnp.asarray(seed.numpy()),
                         jnp.asarray(table.numpy().reshape(1, 128))))
    got = vpu_peak.vpu_peak(seed, table, tiles, rounds, case)
    assert got.dtype == torch.int32 and tuple(got.shape) == (32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vpu_peak_inputs_match_jax_tool(jax_vpu_peak):
    """The seed block and table of tools/vpu_peak.py:_run_case."""
    seed, table = vpu_peak.inputs("cpu")
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(seed.numpy(), rng.integers(
        0, 1 << 20, size=(jax_vpu_peak.SLAB, jax_vpu_peak.LANES),
        dtype=np.int32))
    np.testing.assert_array_equal(table.numpy(), np.arange(128))
    assert vpu_peak.N_ACC == jax_vpu_peak.N_ACC


def _sass_function(name, loop_body):
    """A kernel in `cuobjdump -sass`'s layout: one instruction, a loop of
    `loop_body` plus a compare and its backward branch, a NOP, EXIT, and
    the trailing branch to itself."""
    ops = ["MOV R1, c[0x0][0x28]", *loop_body,
           "ISETP.NE.AND P0, PT, R5, RZ, PT", "@P0 BRA 0x10", "NOP", "EXIT"]
    ops.append(f"BRA {hex(16 * len(ops))}")
    lines = [f"        Function : {name}"] + [
        f"        /*{16 * i:04x}*/                   {op} ;"
        for i, op in enumerate(ops)]
    return "\n".join(lines) + "\n"


def test_sass_loop_reader():
    """A backward branch closes a loop (predicates stripped, NOPs dropped);
    the trailing self-branch is not a loop; each vpu_peak case maps to its
    instantiation's round loop."""
    body = ["IADD3 R2, R2, R3, RZ", "NOP",
            "LOP3.LUT R4, R4, R2, RZ, 0x3c, !PT"]
    loops = synth_cuda.sass_loops(_sass_function("k", body))
    assert loops == {"k": [["IADD3", "LOP3.LUT", "ISETP.NE.AND", "BRA"]]}
    names = {"alu": "ILi32ELi0ELi0ELi0E", "gather": "ILi32ELi4ELi0ELi0E",
             "mix": "ILi38ELi2ELi0ELi0E", "imul": "ILi32ELi0ELi1ELi4E",
             "f32rt": "ILi32ELi0ELi2ELi4E"}
    text = "".join(_sass_function(
        f"_ZN12_GLOBAL__N_115vpu_peak_kernel{args}EvPKiS1_Piii",
        body * (k + 1)) for k, args in enumerate(names.values()))
    counts = vpu_peak.round_instructions(synth_cuda.sass_loops(text))
    assert counts == {name: 2 * k + 4 for k, name in enumerate(names)}


def test_vpu_peak_refuses_bad_operands():
    seed, table = vpu_peak.inputs("cpu")
    with pytest.raises(ValueError, match="case must be one of"):
        vpu_peak.vpu_peak(seed, table, 1, 1, "tree")
    with pytest.raises(TypeError):
        vpu_peak.vpu_peak(seed.long(), table, 1, 1, "alu")
    with pytest.raises(ValueError, match="measures a CUDA device"):
        vpu_peak.measure("cpu")


def test_ab_kernel_cpu_plumbing(tmp_path, capsys):
    out = tmp_path / "ab.json"
    assert ab_kernel.main(["--b", "nav_gather", "--cpu", "--batch-epochs",
                           "1", "--passes", "1", "--reps", "2", "--fmt", "1",
                           "--json", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(out.read_text())
    assert line["bit_equal"] and line["backend"] == "cpu"
    assert line["a"] == "default" and line["b"] == "nav_gather"
    assert sorted(line["reps_s"]) == ["default", "nav_gather"]
    assert all(len(v) == 2 for v in line["reps_s"].values())
    assert line["b_over_a"] == line["best_s"]["nav_gather"] / \
        line["best_s"]["default"]


def test_time_ms_on_the_host():
    """The shared timer: one warm-up call, then the best of `reps`."""
    calls = []
    ms = card.time_ms(lambda: calls.append(1), 3, "cpu")
    assert len(calls) == 4 and 0 <= ms < 1e3
    card.time_ms(lambda: calls.append(1), 2, "cpu", warm=False)
    assert len(calls) == 6


def test_ab_compare_refuses_to_time_unequal_variants():
    out = ab_kernel.compare({"a": lambda: torch.zeros(3),
                             "b": lambda: torch.ones(3)}, device="cpu")
    assert out == {"bit_equal": False}


@pytest.mark.parametrize("variant", ab_kernel.TPU_ONLY)
def test_ab_kernel_refuses_tpu_only_variants(capsys, variant):
    assert ab_kernel.main(["--b", variant, "--cpu", "--batch-epochs",
                           "1"]) == 2
    assert "lowering choice of the TPU kernel" in capsys.readouterr().err


def test_profile_writes_trace(tmp_path, capsys):
    """--profile DIR on the CPU: a Chrome trace of the run lands in DIR,
    the output bytes are those of a run without the flag, and stderr ends
    with the JAX CLI's line."""
    prof = tmp_path / "prof"
    run = STATIC + ["--impl", "torch", "--device", "cpu"]
    assert main(run + ["-o", str(tmp_path / "plain.bin")]) == 0
    capsys.readouterr()
    assert main(run + ["-o", str(tmp_path / "prof.bin"), "--profile",
                       str(prof)]) == 0
    err = capsys.readouterr().err.splitlines()
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert (tmp_path / "prof.bin").read_bytes() == \
        (tmp_path / "plain.bin").read_bytes()
    assert jax_main(STATIC + ["--impl", "xla", "-o",
                              str(tmp_path / "jax.bin"), "--profile",
                              str(prof)]) == 0
    assert err[-1] == capsys.readouterr().err.splitlines()[-1] == \
        f"profiler trace written to {prof}"
