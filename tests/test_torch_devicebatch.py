"""The port's DeviceBatch path on the CPU against the JAX package.

- ops/synth_closed.py (the closed form in plain torch) equals
  gps_sdr_sim_tpu/ops/synth_jnp.py: synth_batch and the raw accumulate;
- the row kernel's plain versions (ops.synth.synth_rows_planes_ref and
  synth_rows_raw_ref on ops.synth.pack_rows) equal the Pallas kernel's
  row-parameter form in the interpreter (synth_pallas.synth_batch, and
  _get_pallas_fn(C, quantize=False)), and the wire form's plain versions on
  the same epochs;
- synth_batch_sharded and synth_rows_sharded on meshes that repeat the CPU
  device equal the unsharded JAX result, 7 epochs on time axes up to 8
  (padding), and a chan axis that does not divide the channels raises;
- run_simulation with impl closed / closed-sharded writes the bytes of the
  JAX impls xla / xla-sharded in SC16/SC08/SC01, the CLI with --impl closed
  the JAX CLI's bytes and stderr with --impl xla, the 11 goldens pass
  through closed, and shard files with closed concatenate to the single
  file.

Every input comes from one scenario built by the port and handed to both
packages as numpy arrays. The arithmetic is exact integer arithmetic (the
two float32 floors included), so every comparison is exact (tolerance 0)."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.cli import main as jax_main
from gps_sdr_sim_tpu.models import scenario as jax_scenario
from gps_sdr_sim_tpu.ops import plan as jax_plan
from gps_sdr_sim_tpu.ops import synth_jnp, synth_pallas
from gps_sdr_sim_tpu.runner import run_simulation as jax_run_simulation
from gps_sdr_sim_tpu_torch.cli import main
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth, synth_closed
from gps_sdr_sim_tpu_torch.ops.plan import plan_batch, plan_epochs
from gps_sdr_sim_tpu_torch.parallel import (
    concat_shards,
    make_mesh,
    run_simulation_sharded,
    synth_batch_sharded,
    synth_rows_sharded,
)
from gps_sdr_sim_tpu_torch.parallel.mesh import Mesh
from gps_sdr_sim_tpu_torch.runner import run_simulation
from gps_sdr_sim_tpu_torch.testing import (
    NAV,
    SCENARIOS,
    TOKYO,
    check,
    load_goldens,
    synthesize,
)

from test_torch_runner import STATIC, _strip_stderr

CPU = torch.device("cpu")
QUIET = dict(log=lambda s: None)
MESHES = [(2, 1), (8, 1), (1, 8), (4, 2), (2, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run torch on one thread here: the suite runs several test processes
    on a few cores, and these small ops stall on contended intra-op
    threads (ROADMAP C3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(duration, samp_freq, data_format=16):
    return ScenarioConfig(nav_file=str(NAV), static_xyz=TOKYO,
                          duration=duration, samp_freq=samp_freq,
                          data_format=data_format)


def _jax_scenario(cfg):
    return jax_scenario.build_scenario(jax_scenario.ScenarioConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))


def _batch(scn, e0=0, e1=None):
    seg = scn.segments[0]
    return plan_batch(seg, e0, seg.n_epochs if e1 is None else e1,
                      scn.iq_buff_size, scn.delt)


def _jax_batch(db):
    """The same arrays as the JAX package's DeviceBatch."""
    return jax_plan.DeviceBatch(**vars(db))


def _channels(db, cs):
    """The batch cut to channel columns `cs`."""
    def cut(name, a):
        if name == "ca_words":
            return a[cs]
        if name in ("code_p", "carr_p", "t_base"):
            return a[:, :, cs]
        return a[:, cs]

    return dataclasses.replace(db, **{
        f.name: cut(f.name, getattr(db, f.name))
        for f in dataclasses.fields(db)})


def _interleave(planes, n_out):
    i16, q16 = planes
    return torch.stack([i16[:, :n_out], q16[:, :n_out]], dim=-1).numpy()


@pytest.fixture(scope="module")
def tokyo():
    """The JAX package's sharding scenario (tests/test_parallel.py): Tokyo,
    0.8 s at 200 ksps, 7 epochs of 10 sub-blocks x 16 channels."""
    scn = build_scenario(_config(0.8, 2.0e5))
    db = _batch(scn)
    ref = np.asarray(synth_jnp.synth_batch(_jax_batch(db), scn.iq_buff_size))
    return scn, db, ref


@pytest.mark.parametrize("samp_freq,duration", [
    (2.0e5, 0.8), (1.0e6, 0.3), (2.6e6, 0.3)])
def test_closed_synth_batch_matches_synth_jnp(tokyo, samp_freq, duration):
    if samp_freq == 2.0e5:
        scn, db, want = tokyo
    else:
        scn = build_scenario(_config(duration, samp_freq))
        db = _batch(scn)
        want = np.asarray(synth_jnp.synth_batch(_jax_batch(db),
                                                scn.iq_buff_size))
    got = synth_closed.synth_batch(db, scn.iq_buff_size, CPU)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_closed_accumulate_matches_synth_jnp(tokyo):
    """The raw int32 sums before (acc + 64) >> 7, which a chan shard
    returns."""
    _, db, _ = tokyo
    db = _channels(db, list(range(6)))
    got = synth_closed.accumulate(*synth_closed.batch_tensors(db, CPU))
    fix = synth_jnp._trig_corrections("cpu")
    want = synth_jnp.accumulate(
        *(jnp.asarray(getattr(db, f)) for f in synth_closed.FIELDS),
        n_chan=6, sin_fix=fix[0], cos_fix=fix[1])
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def cut_batch(tokyo):
    """3 epochs and 2 channel columns, the first live and one of gain 0:
    the Pallas interpreter's time grows with the channel count."""
    scn, db, _ = tokyo
    db = _channels(_batch(scn, 0, 3), [0, 13])
    assert (db.gain[:, 0] != 0).all() and (db.gain[:, 1] == 0).all()
    return scn, db


def test_row_planes_plain_matches_pallas_interpreter(cut_batch):
    scn, db = cut_batch
    n = scn.iq_buff_size
    want = np.asarray(synth_pallas.synth_batch(_jax_batch(db), n))
    rows = torch.from_numpy(synth.pack_rows(db))
    ca = torch.from_numpy(db.ca_words)
    got = _interleave(synth.synth_rows_planes_ref(rows, ca), n)
    np.testing.assert_array_equal(got, want)
    # On the CPU the wrapper and synth_batch take the plain version.
    np.testing.assert_array_equal(
        _interleave(synth.synth_rows_planes(rows, ca), n), want)
    np.testing.assert_array_equal(synth.synth_batch(db, n, CPU).numpy(), want)


def test_row_raw_plain_matches_pallas_interpreter(cut_batch):
    _, db = cut_batch
    B, SB, C = db.t_base.shape
    fn = synth_pallas._get_pallas_fn(C, quantize=False)
    want = fn(jnp.asarray(synth_pallas.pack_params(_jax_batch(db))),
              jnp.asarray(db.ca_words))
    rows = torch.from_numpy(synth.pack_rows(db))
    ca = torch.from_numpy(db.ca_words)
    for got_fn in (synth.synth_rows_raw_ref, synth.synth_rows_raw):
        for g, w in zip(got_fn(rows, ca), want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(w)[:B * SB].reshape(B, -1))


@pytest.mark.parametrize("samp_freq", [2.0e5, 1.0e6, 2.6e6])
def test_row_plain_matches_wire_plain(samp_freq):
    """The same epoch as rows (all 16 channels, host rebase) and as the
    wire (active channels only, rebase in the plain version): equal planes
    and raw sums."""
    scn = build_scenario(_config(0.3, samp_freq))
    seg = scn.segments[0]
    n = scn.iq_buff_size
    db = _batch(scn, 1, 2)
    rows = torch.from_numpy(synth.pack_rows(db))
    ca = torch.from_numpy(db.ca_words)
    st = synth.stage_epochs(plan_epochs(seg, 1, 2, scn.delt), CPU)
    for row_fn, wire_fn in (
            (synth.synth_rows_planes_ref, synth.synth_wire_planes_ref),
            (synth.synth_rows_raw_ref, synth.synth_wire_raw_ref)):
        for g, w in zip(row_fn(rows, ca), wire_fn(*st, n)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("fn", [synth_batch_sharded, synth_rows_sharded],
                         ids=["closed", "rows"])
@pytest.mark.parametrize("n_time,n_chan", MESHES)
def test_sharded_matches_unsharded_jax(tokyo, fn, n_time, n_chan):
    """(8, 1) puts 7 epochs on an 8-wide time axis: padding is silent and
    stripped, and the empty shard is not run."""
    scn, db, want = tokyo
    mesh = make_mesh(n_time, n_chan, [CPU] * (n_time * n_chan))
    pieces = fn(db, scn.iq_buff_size, mesh)
    assert len(pieces) == min(n_time, 7)
    np.testing.assert_array_equal(torch.cat(pieces).numpy(), want)


@pytest.mark.parametrize("fn", [synth_batch_sharded, synth_rows_sharded],
                         ids=["closed", "rows"])
def test_chan_axis_must_divide_the_channels(tokyo, fn):
    scn, db, _ = tokyo
    with pytest.raises(ValueError, match="not divisible by mesh 'chan'"):
        fn(db, scn.iq_buff_size, Mesh(((CPU,) * 3,)))


def _run(run, scn, **kw):
    buf = io.BytesIO()
    run(scn, buf, batch_epochs=3, log=lambda s: None, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", [16, 8, 1])
@pytest.mark.parametrize("sharded", [False, True], ids=["closed",
                                                         "closed-sharded"])
def test_runner_closed_matches_jax_xla(fmt, sharded):
    """4 epochs in batches of 3 (a padded last batch); closed-sharded on a
    2x2 mesh of the CPU against xla-sharded on the 8 virtual devices."""
    cfg = _config(0.5, 1.0e6, fmt)
    if sharded:
        got = _run(run_simulation, build_scenario(cfg),
                   impl="closed-sharded", device=CPU,
                   mesh=make_mesh(2, 2, [CPU] * 4))
        want = _run(jax_run_simulation, _jax_scenario(cfg),
                    impl="xla-sharded")
    else:
        got = _run(run_simulation, build_scenario(cfg), impl="closed",
                   device=CPU)
        want = _run(jax_run_simulation, _jax_scenario(cfg), impl="xla")
    assert len(got) == 4 * synth.packed_bytes(100000, fmt)
    assert got == want


@pytest.mark.parametrize("extra", [[], ["-b", "8", "-v"]])
def test_cli_closed_matches_jax_cli_xla(tmp_path, capsys, extra):
    ours, ref = tmp_path / "ours.bin", tmp_path / "ref.bin"
    assert main(STATIC + extra + ["-o", str(ours), "--impl", "closed",
                                  "--device", "cpu"]) == 0
    err_ours = capsys.readouterr().err
    assert jax_main(STATIC + extra + ["-o", str(ref), "--impl", "xla"]) == 0
    err_ref = capsys.readouterr().err
    assert ours.read_bytes() == ref.read_bytes()
    assert _strip_stderr(err_ours) == _strip_stderr(err_ref)


def test_closed_needs_the_device_it_is_given(tmp_path, capsys):
    """No silent CPU fallback: --impl closed runs on --device (default
    cuda), and without a usable CUDA device it exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main(STATIC + ["--impl", "closed", "-o", str(tmp_path / "x.bin")])
    assert e.value.code == 1
    assert "ERROR: CUDA device 'cuda' is not available." in \
        capsys.readouterr().err
    assert not (tmp_path / "x.bin").exists()


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_through_closed(goldens, name):
    check(synthesize(name, impl="closed", device=CPU), goldens[name],
          SCENARIOS[name]["data_format"])


def test_shard_dir_closed_matches_single_file(tmp_path):
    scn = build_scenario(_config(0.7, 1.0e6))
    single = _run(run_simulation, scn, impl="closed", device=CPU)
    run_simulation_sharded(scn, str(tmp_path / "sd"), n_shards=3,
                           batch_epochs=2, impl="closed", device=CPU)
    concat_shards(str(tmp_path / "sd"), str(tmp_path / "joined.bin"))
    assert (tmp_path / "joined.bin").read_bytes() == single


def test_pack_rows_layout(tokyo):
    """Each row holds the DeviceBatch's integers whole: the 16-bit limbs
    reassembled, per-epoch fields repeated over the sub-blocks, m0 folded
    to m0 - 20 * b0."""
    _, db, _ = tokyo
    rows = synth.pack_rows(db).astype(np.int64)
    B, SB, C = db.t_base.shape
    assert rows.shape == (B, SB, C, synth.ROW_LANES)

    def u64(lane):
        return (rows[..., lane] & 0xFFFFFFFF) | (rows[..., lane + 1] << 32)

    def limbs(a):
        return a[..., 0] + (a[..., 1] << 16) + (a[..., 2] << 32)

    np.testing.assert_array_equal(u64(0), limbs(db.code_p.astype(np.int64)))
    np.testing.assert_array_equal(u64(4), limbs(db.carr_p.astype(np.int64)))
    for lane, per_epoch in ((2, limbs(db.code_s.astype(np.int64))),
                            (6, limbs(db.carr_s.astype(np.int64))),
                            (9, db.m0 - 20 * db.b0), (10, db.navbits),
                            (11, db.gain)):
        got = u64(lane) if lane in (2, 6) else rows[..., lane]
        np.testing.assert_array_equal(
            got, np.broadcast_to(per_epoch[:, None], (B, SB, C)))
    np.testing.assert_array_equal(rows[..., 8], db.t_base)


def test_pad_time_is_silent(tokyo):
    """_pad_time's epochs repeat the last epoch's ramps with gain 0."""
    from gps_sdr_sim_tpu_torch.parallel.shard import _pad_time

    _, db, _ = tokyo
    padded, b = _pad_time(db, 4)
    assert b == 7 and padded.gain.shape[0] == 8
    assert (padded.gain[7] == 0).all()
    np.testing.assert_array_equal(padded.code_p[7], db.code_p[6])
    assert padded.ca_words is db.ca_words


@pytest.mark.parametrize("case", ["dtype", "lanes", "channels", "ca_shape",
                                  "contiguous"])
def test_row_wrappers_check_their_operands(cut_batch, case):
    """The wrappers raise on what the kernel does not take, before either
    the kernel or the plain version runs."""
    _, db = cut_batch
    rows = torch.from_numpy(synth.pack_rows(db))
    ca = torch.from_numpy(db.ca_words)
    bad = {
        "dtype": (rows.to(torch.int64), ca, TypeError),
        "lanes": (rows[..., :8].contiguous(), ca, ValueError),
        "channels": (rows.repeat(1, 1, 9, 1), ca.repeat(9, 1), ValueError),
        "ca_shape": (rows, ca[:1], ValueError),
        "contiguous": (rows.transpose(0, 1), ca, ValueError),
    }[case]
    for fn in (synth.synth_rows_planes, synth.synth_rows_raw):
        with pytest.raises(bad[2]):
            fn(bad[0], bad[1])
