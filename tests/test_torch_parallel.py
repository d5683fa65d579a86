"""The port's sharded path on the CPU (gps_sdr_sim_tpu_torch.parallel).

- synth_epochs_sharded over meshes that repeat the CPU device equals the
  JAX package's on its 8-virtual-device mesh, for five (time, chan)
  factorizations, with 7 epochs on time axes of 2, 4 and 8 (padding) and
  channel padding on every chan axis above 1;
- the counterparts of tests/test_parallel.py's shard-file tests: shard
  ranges, concatenation, resume, stats, and the sharded runner impls;
- the manifest is the JAX writer's, byte for byte.

All arithmetic is integer, so every comparison is exact (tolerance zero)."""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.models import scenario as jax_scenario
from gps_sdr_sim_tpu.ops import plan as jax_plan
from gps_sdr_sim_tpu.parallel import auto_mesh as jax_auto_mesh
from gps_sdr_sim_tpu.parallel import synth_epochs_sharded as jax_sharded
from gps_sdr_sim_tpu.parallel.writer import (
    run_simulation_sharded as jax_run_simulation_sharded,
)
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.ops.plan import plan_epochs
from gps_sdr_sim_tpu_torch.parallel import (
    auto_mesh,
    concat_shards,
    make_mesh,
    plan_epoch_shards,
    run_simulation_sharded,
    synth_epochs_sharded,
)
from gps_sdr_sim_tpu_torch.parallel import shard
from gps_sdr_sim_tpu_torch.parallel.mesh import CHAN_AXIS, TIME_AXIS
from gps_sdr_sim_tpu_torch.runner import run_epoch_range, run_simulation
from gps_sdr_sim_tpu_torch.testing import NAV, TOKYO, random_wire

CPU = torch.device("cpu")
SAMP = 2.0e5  # small epochs; sharding is rate-independent
QUIET = dict(log=lambda s: None)


def _port_config(duration, data_format=16, static_xyz=TOKYO):
    return ScenarioConfig(nav_file=str(NAV), static_xyz=static_xyz,
                          duration=duration, samp_freq=SAMP,
                          data_format=data_format)


def _jax_config(cfg):
    """The JAX package's ScenarioConfig with the same fields."""
    return jax_scenario.ScenarioConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def scenario():
    return build_scenario(_port_config(0.8))


def _first_channels(eb, c):
    """The batch cut to its first c channel columns (active first)."""
    cut = {k: v[:, :c] for k, v in vars(eb).items()
           if isinstance(v, np.ndarray) and v.ndim == 2 and k != "ca_words"}
    return dataclasses.replace(eb, **cut, ca_words=eb.ca_words[:c],
                               n_chan=min(eb.n_chan, c))


@pytest.fixture(scope="module")
def batches():
    """7 epochs over 3 channel columns in both packages: the Pallas
    interpreter's time grows with channels per device, and 3 columns
    need channel padding on every chan axis above 1."""
    cfg = _port_config(0.8)
    ref = jax_scenario.build_scenario(_jax_config(cfg))
    scn = build_scenario(cfg)
    return (_first_channels(jax_plan.plan_epochs(ref.segments[0], 0, 7,
                                                 ref.delt), 3),
            _first_channels(plan_epochs(scn.segments[0], 0, 7, scn.delt), 3),
            scn.iq_buff_size)


@pytest.mark.parametrize("n_time,n_chan",
                         [(2, 1), (8, 1), (1, 8), (4, 2), (2, 4)])
def test_sharded_matches_jax(batches, n_time, n_chan):
    eb_jax, eb, n = batches
    want = np.asarray(jax_sharded(eb_jax, n, jax_auto_mesh(n_time * n_chan,
                                                           n_chan)))
    mesh = make_mesh(n_time, n_chan, [CPU] * (n_time * n_chan))
    for plain in (False, True):
        pieces = synth_epochs_sharded(eb, n, mesh, plain=plain)
        # One piece per time shard that holds a valid epoch.
        assert len(pieces) == -(-7 // -(-7 // n_time))
        got = torch.cat(pieces).numpy()
        assert got.dtype == np.int16 and got.shape == (7, n, 2)
        np.testing.assert_array_equal(got, want)


def test_chan_reduction_wraps_like_psum():
    """Raw partial sums over four chan shards, added mod 2^32 and then
    quantized, equal the planes over all 16 channels, also where the
    channel sums leave the int32 range (huge gains)."""
    wire, ca, _ = random_wire(7, n_epochs=2, n_chan=16)
    wire[..., 11] = 1 << 26
    w, c = torch.from_numpy(wire), torch.from_numpy(ca)
    raw = [synth.synth_wire_raw_ref(w[:, k:k + 4].contiguous(),
                                    c[k:k + 4].contiguous(), 4, 4096)
           for k in range(0, 16, 4)]
    for plane in (0, 1):
        parts = [r[plane] for r in raw]
        assert int(sum(p.long() for p in parts).abs().max()) > 2 ** 31
        want = synth.synth_wire_planes_ref(w, c, 16, 4096)[plane]
        assert torch.equal(shard._reduce_chan(parts, CPU), want)


def test_mesh_checks():
    mesh = make_mesh(2, 4, [CPU] * 8)
    assert mesh.shape == {TIME_AXIS: 2, CHAN_AXIS: 4}
    assert mesh.grid[1][0] == CPU
    assert auto_mesh(device="cpu").shape == {TIME_AXIS: 1, CHAN_AXIS: 1}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(2, 2, [CPU] * 3)
    with pytest.raises(ValueError, match="must divide MAX_CHAN"):
        make_mesh(1, 3, [CPU] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        auto_mesh(n_chan=2, device="cpu")


# ---------------------------------------------------------------------------
# Counterparts of tests/test_parallel.py's shard-file tests.
# ---------------------------------------------------------------------------


def _single(scn):
    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=2, impl="torch", device=CPU,
                   **QUIET)
    return buf.getvalue()


def _sharded(scn, out_dir, n_shards, **kw):
    return run_simulation_sharded(scn, str(out_dir), n_shards=n_shards,
                                  batch_epochs=2, impl="torch", device=CPU,
                                  **kw)


def test_plan_epoch_shards():
    assert plan_epoch_shards(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert plan_epoch_shards(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


@pytest.mark.parametrize("data_format", [16, 1])
def test_shard_files_concat_bitexact(tmp_path, data_format):
    scn = build_scenario(_port_config(0.7, data_format))
    want = _single(scn)
    _sharded(scn, tmp_path / "s", 3)
    manifest = concat_shards(str(tmp_path / "s"), str(tmp_path / "j.bin"))
    assert manifest.total_epochs == scn.n_output_epochs
    assert (tmp_path / "j.bin").read_bytes() == want


def test_shard_resume_regenerates_missing(tmp_path):
    scn = build_scenario(_port_config(0.5))
    out_dir = tmp_path / "shards"
    _sharded(scn, out_dir, 2)
    victim = out_dir / "shard_00001.bin"
    good = victim.read_bytes()
    victim.write_bytes(good[: len(good) // 2])  # a failed process
    mtime0 = (out_dir / "shard_00000.bin").stat().st_mtime_ns
    _sharded(scn, out_dir, 2, resume=True)
    assert victim.read_bytes() == good
    assert (out_dir / "shard_00000.bin").stat().st_mtime_ns == mtime0


def test_shard_resume_refuses_different_scenario(tmp_path):
    out_dir = tmp_path / "shards"
    _sharded(build_scenario(_port_config(0.4)), out_dir, 2)
    other = build_scenario(_port_config(
        0.4, static_xyz=np.array([-3961904.9, 3348993.8, 3698211.7])))
    with pytest.raises(ValueError, match="different scenario"):
        _sharded(other, out_dir, 2, resume=True)
    _sharded(build_scenario(_port_config(0.4)), out_dir, 2, resume=True)


def test_sharded_run_returns_aggregated_stats(tmp_path):
    scn = build_scenario(_port_config(0.4))
    _manifest, stats = _sharded(scn, tmp_path / "s", 2)
    assert stats.total_samples == scn.total_samples
    assert stats.device_batches >= 2
    assert stats.wall_seconds > 0


def test_epoch_range_split_anywhere_bitexact(scenario):
    n = scenario.n_output_epochs
    whole = _single(scenario)
    for k, be in ((1, 3), (n // 2, 7), (n - 1, 20)):
        parts = io.BytesIO()
        for lo, hi in ((0, k), (k, n)):
            run_epoch_range(scenario, parts, lo, hi, batch_epochs=be,
                            impl="torch", device=CPU, **QUIET)
        assert parts.getvalue() == whole, (k, be)


@pytest.mark.parametrize("mesh_shape", [None, (2, 2), (3, 1)])
def test_torch_sharded_matches_torch(scenario, mesh_shape):
    """The runner's sharded impl on the default (1x1) CPU mesh and on
    repeated-CPU meshes, with batches that leave a time shard empty."""
    mesh = None
    if mesh_shape:
        mesh = make_mesh(*mesh_shape, [CPU] * (mesh_shape[0] * mesh_shape[1]))
    for fmt in (16, 8, 1):
        scn = build_scenario(_port_config(0.8, fmt))
        buf = io.BytesIO()
        run_simulation(scn, buf, batch_epochs=5, impl="torch-sharded",
                       device=CPU, mesh=mesh, **QUIET)
        assert buf.getvalue() == _single(scn), fmt


def test_cuda_sharded_refuses_a_cpu_mesh(scenario, monkeypatch):
    """No silent fallback: the kernel impl on a mesh of CPU entries raises
    instead of running the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="needs a mesh of CUDA devices"):
        run_simulation(scenario, io.BytesIO(), impl="cuda-sharded",
                       device="cuda", mesh=make_mesh(1, 1, [CPU]), **QUIET)


def test_manifest_equals_jax_writer(tmp_path):
    """Same scenario, same shard count: the same manifest.json text,
    scenario hash included."""
    cfg = _port_config(0.4, 1)
    _sharded(build_scenario(cfg), tmp_path / "port", 3)
    jax_run_simulation_sharded(jax_scenario.build_scenario(_jax_config(cfg)),
                               str(tmp_path / "jax"), n_shards=3,
                               batch_epochs=2, impl="xla")
    for name in ["manifest.json"] + [f"shard_{i:05d}.bin" for i in range(3)]:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
