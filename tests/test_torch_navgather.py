"""The nav mask-table variant of the port's synthesis (nav_gather=True, the
JAX package's `tpe > 0` kernel, GPS_SDR_SIM_NAV_GATHER=1) against the JAX
package.

The gather variant is held to the JAX gather kernel run by the Pallas
interpreter, in all five outputs (SC16, SC08, SC01 words, int16 planes, raw
int32 sums), on a real 1 Msps plan and on seeded random wires whose t0 = -1
rows reach code period M = -1. It equals the window walk on real plans,
and differs from it exactly where T = -1 meets a table lane 127 whose bit
is not the walk's sign fill. All arithmetic is integer, so every
comparison is exact (tolerance zero). Channels are cut to a few wherever
the interpreter runs: its compile time grows with the channel count."""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.cli import main as jax_main
from gps_sdr_sim_tpu.models import scenario as jax_scenario
from gps_sdr_sim_tpu.ops import synth_pallas
from gps_sdr_sim_tpu.ops.plan import plan_epochs as jax_plan_epochs
from gps_sdr_sim_tpu.parallel import auto_mesh as jax_auto_mesh
from gps_sdr_sim_tpu.parallel import shard as jax_shard
from gps_sdr_sim_tpu_torch.cli import main
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.ops.plan import pack_epoch_wire, plan_epochs
from gps_sdr_sim_tpu_torch.ops.quantize import words_to_bytes
from gps_sdr_sim_tpu_torch.parallel import make_mesh, synth_epochs_sharded
from gps_sdr_sim_tpu_torch.runner import run_simulation
from gps_sdr_sim_tpu_torch.testing import (
    NAV,
    SCENARIOS,
    TOKYO,
    check,
    load_goldens,
    random_wire,
    synthesize,
)

from test_torch_parallel import _first_channels
from test_torch_runner import STATIC, _strip_stderr

CPU = torch.device("cpu")
N_CHAN = 2          # channels summed wherever the interpreter runs
N_OUT_RANDOM = 5000  # mid sub-block: 3 sub-blocks per epoch
OUTPUTS = ["16", "8", "1", "planes", "raw"]


@pytest.fixture(scope="module")
def real_wire():
    """Two epochs of Tokyo static at 1 Msps: the wire (all 16 columns) and
    C/A words; the kernels sum the first N_CHAN channels."""
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=0.3, samp_freq=1.0e6))
    eb = plan_epochs(scn.segments[0], 0, 2, scn.delt)
    assert eb.n_chan > N_CHAN
    return pack_epoch_wire(eb), eb.ca_words, scn.iq_buff_size


@functools.lru_cache(maxsize=None)
def _jax_raw_gather_fn(n_chan, sb):
    """Wire -> raw int32 (I, Q) of the JAX tpe > 0 kernel, fed
    _wire_to_params and nav_table_from_wire as the sharded path feeds it."""
    tile, sbp = synth_pallas._aligned_tile(sb)
    fn = synth_pallas._get_pallas_fn(n_chan, quantize=False, uniform=True,
                                     tile_rows=tile, tpe=sbp // tile)

    @jax.jit
    def run(w, c):
        params, _rows = synth_pallas._wire_to_params(w, sb, align=True)
        return fn(params, c, synth_pallas.nav_table_from_wire(w))

    return run


def _jax_gather(wire, ca, n_chan, n_out, output):
    """The JAX tpe > 0 kernel (Pallas interpreter), valid prefix only:
    bytes for the packed formats, (I, Q) [B, n_out] for planes and raw."""
    sb = -(-n_out // synth_pallas.SUBBLOCK)
    w, c = jnp.asarray(wire), jnp.asarray(ca)
    if output == "raw":
        i, q = _jax_raw_gather_fn(n_chan, sb)(w, c)
        B = wire.shape[0]
        return tuple(np.asarray(x).reshape(B, -1)[:, :n_out] for x in (i, q))
    fmt = None if output == "planes" else int(output)
    out = np.asarray(synth_pallas._get_epoch_fn(n_chan, sb, n_out, fmt=fmt,
                                                nav_gather=True)(w, c))
    if fmt is None:
        return out[..., 0], out[..., 1]
    return words_to_bytes(out, n_out, fmt)


def _port(wire, ca, n_chan, n_out, output, nav_gather=True):
    """The port's wrapper on CPU tensors (its plain version), valid prefix
    only, in _jax_gather's layout."""
    w, c = torch.from_numpy(wire), torch.from_numpy(ca)
    if output in ("planes", "raw"):
        fn = getattr(synth, f"synth_wire_{output}")
        return tuple(x.numpy()[:, :n_out] for x in fn(
            w, c, n_chan, n_out, nav_gather=nav_gather))
    fmt = int(output)
    words = synth.synth_wire(w, c, n_chan, n_out, fmt, nav_gather=nav_gather)
    return words_to_bytes(words.numpy(), n_out, fmt)


def _assert_equal(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("output", OUTPUTS)
def test_gather_matches_pallas_interpret_real_plan(real_wire, output):
    wire, ca, n = real_wire
    _assert_equal(_port(wire, ca, N_CHAN, n, output),
                  _jax_gather(wire, ca, N_CHAN, n, output))


@pytest.mark.parametrize("output", OUTPUTS)
def test_gather_matches_pallas_interpret_random_wires(output):
    """Eight seeded wires, 40% of rows with t0 = -1 (T = -1 at the first
    samples of the epoch), gains up to 400."""
    seen_t_minus_one = 0
    for seed in range(8):
        wire, ca, _ = random_wire(seed, n_epochs=3, n_chan=N_CHAN,
                                  max_gain=400)
        seen_t_minus_one += int((wire[:, :N_CHAN, 8] == -1).sum())
        _assert_equal(_port(wire, ca, N_CHAN, N_OUT_RANDOM, output),
                      _jax_gather(wire, ca, N_CHAN, N_OUT_RANDOM, output))
    assert seen_t_minus_one > 0


# ---------------------------------------------------------------------------
# Gather against the walk: where T = -1 meets lane 127.
# ---------------------------------------------------------------------------


def test_gather_equals_walk_on_real_plan(real_wire):
    """All channels of a real plan: T is never -1 there (t0 >= 0)."""
    wire, ca, n = real_wire
    n_chan = int((wire[0, :, 11] != 0).sum())
    w, c = torch.from_numpy(wire), torch.from_numpy(ca)
    walk = synth.synth_wire_raw(w, c, n_chan, n)
    gather = synth.synth_wire_raw(w, c, n_chan, n, nav_gather=True)
    assert n_chan > N_CHAN
    assert all(torch.equal(a, b) for a, b in zip(walk, gather))


def _t_minus_one_positions(wire, n_chan):
    """{(epoch, sample)} where some channel < n_chan with gain != 0 has
    T = -1 and bit 6 of its window set. For these wires (t0 = -1 rows have
    m0 = 20 * b0) the walk's index there is floor((m0r - 1) / 20) = -1,
    which sign-fills to bit 31 (0, navbits < 256); the table's lane 127 is
    bit clip(floor((m0 + 127) / 20) - b0, 0, 31) = 6. T comes from the
    code phase of sub-block 0: t0 + (((f >> 16) + r * (s >> 16)) >> 40)."""
    pos = set()
    for b in range(wire.shape[0]):
        for c in range(n_chan):
            row = wire[b, c]
            f = int(row[0:2].copy().view(np.int64)[0])
            s = int(row[2:4].copy().view(np.int64)[0])
            m0, b0 = int(row[9]) & 0xFFFF, int(row[9]) >> 16
            if row[8] != -1 or row[11] == 0:
                continue
            assert m0 == 20 * b0 and 0 <= row[10] < 256
            assert (m0 + 127) // 20 - b0 == 6
            lane127 = (int(row[10]) >> 6) & 1
            r = 0
            while -1 + (((f >> 16) + r * (s >> 16)) >> 40) == -1:
                if lane127:
                    pos.add((b, r))
                r += 1
    return pos


def test_gather_differs_from_walk_exactly_at_t_minus_one():
    """The raw channel sums of gather and walk differ at exactly the
    predicted (epoch, sample) positions, on every seed; and the JAX gather
    kernel differs from the JAX walk kernel at the same SC16 words."""
    total = 0
    for seed in range(8):
        wire, ca, _ = random_wire(seed, n_epochs=3, n_chan=N_CHAN,
                                  max_gain=400)
        walk = _port(wire, ca, N_CHAN, N_OUT_RANDOM, "raw", nav_gather=False)
        gather = _port(wire, ca, N_CHAN, N_OUT_RANDOM, "raw")
        differ = (walk[0] != gather[0]) | (walk[1] != gather[1])
        got = {tuple(p) for p in np.argwhere(differ).tolist()}
        assert got == _t_minus_one_positions(wire, N_CHAN), seed
        total += len(got)
        sb = -(-N_OUT_RANDOM // synth_pallas.SUBBLOCK)
        jax_words = [np.asarray(synth_pallas._get_epoch_fn(
            N_CHAN, sb, N_OUT_RANDOM, fmt=16, nav_gather=g)(
                jnp.asarray(wire), jnp.asarray(ca)))[:, :N_OUT_RANDOM]
            for g in (False, True)]
        port_words = [synth.synth_wire(
            torch.from_numpy(wire), torch.from_numpy(ca), N_CHAN,
            N_OUT_RANDOM, 16, nav_gather=g).numpy()[:, :N_OUT_RANDOM]
            for g in (False, True)]
        np.testing.assert_array_equal(jax_words[0] != jax_words[1],
                                      port_words[0] != port_words[1])
    assert total > 0


# ---------------------------------------------------------------------------
# The mask table.
# ---------------------------------------------------------------------------


def test_floor_of_float_product_equals_integer_floor():
    """JAX's table takes floor((mg + 0.5) * float32(1/20)); the port takes
    floor(mg / 20). Exhaustive over mg in [-1, 65663): m0 < 2^16 plus the
    table's 128 lanes."""
    mg = np.arange(-1, 65663, dtype=np.int32)
    f32 = np.floor((mg.astype(np.float32) + np.float32(0.5))
                   * np.float32(1.0 / 20.0)).astype(np.int32)
    jx = np.asarray(jnp.floor((jnp.asarray(mg).astype(jnp.float32) + 0.5)
                              * synth_pallas._INV20).astype(jnp.int32))
    port = synth.floor_div(torch.from_numpy(mg).long(), 20).numpy()
    np.testing.assert_array_equal(f32, mg // 20)
    np.testing.assert_array_equal(jx, mg // 20)
    np.testing.assert_array_equal(port, mg // 20)


def test_nav_masks_match_jax():
    """Seeded [B, C] fields over the wire's whole m0 range, b0 around
    m0 / 20 (windows before, at and past the table), any 32-bit window."""
    rng = np.random.default_rng(11)
    shape = (5, 16)
    m0 = rng.integers(0, 1 << 16, shape).astype(np.int32)
    b0 = (m0 // 20 + rng.integers(-40, 40, shape)).astype(np.int32)
    navbits = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64) \
        .astype(np.int32)
    want = np.asarray(synth_pallas.nav_masks(
        jnp.asarray(m0), jnp.asarray(b0), jnp.asarray(navbits)))
    got = synth.nav_masks(torch.from_numpy(m0), torch.from_numpy(b0),
                          torch.from_numpy(navbits))
    assert got.dtype == torch.int32 and tuple(got.shape) == (80, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    # And from the wire, as the kernels' table is built.
    wire, _, _ = random_wire(3, n_epochs=2)
    np.testing.assert_array_equal(
        synth.nav_table_from_wire(torch.from_numpy(wire)).numpy(),
        np.asarray(synth_pallas.nav_table_from_wire(jnp.asarray(wire))))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_goldens_with_the_switch(monkeypatch, name):
    """The C-reference goldens through run_simulation(impl="torch") with
    GPS_SDR_SIM_NAV_GATHER=1, which the packed path reads per call."""
    monkeypatch.setenv("GPS_SDR_SIM_NAV_GATHER", "1")
    assert synth.nav_gather_enabled()
    calls = []
    real = synth.synth_wire_ref
    monkeypatch.setattr(synth, "synth_wire_ref",
                        lambda *a: calls.append(a[-1]) or real(*a))
    check(synthesize(name, impl="torch", device=CPU), load_goldens()[name],
          SCENARIOS[name]["data_format"])
    assert calls and all(calls)  # every batch took the gather variant


# ---------------------------------------------------------------------------
# The sharded path and the CLI with the switch.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_time,n_chan", [(2, 2), (2, 1)])
def test_sharded_with_switch_matches_jax(monkeypatch, n_time, n_chan):
    """torch-sharded (raw mode + chan reduction on 2x2, planes on 2x1) with
    nav_gather equals the JAX sharded path with the switch. The JAX wire
    path caches its function without the switch in the key, so the cache
    is cleared before and after."""
    monkeypatch.setenv("GPS_SDR_SIM_NAV_GATHER", "1")
    cfg = dict(nav_file=str(NAV), static_xyz=TOKYO, duration=0.5,
               samp_freq=2.0e5)
    ref = jax_scenario.build_scenario(jax_scenario.ScenarioConfig(**cfg))
    scn = build_scenario(ScenarioConfig(**cfg))
    eb_jax = _first_channels(jax_plan_epochs(ref.segments[0], 0, 4,
                                             ref.delt), N_CHAN)
    eb = _first_channels(plan_epochs(scn.segments[0], 0, 4, scn.delt), N_CHAN)
    n = scn.iq_buff_size
    jax_shard._get_wire_sharded_fn.cache_clear()
    try:
        want = np.asarray(jax_shard.synth_epochs_sharded(
            eb_jax, n, jax_auto_mesh(n_time * n_chan, n_chan)))
    finally:
        jax_shard._get_wire_sharded_fn.cache_clear()
    mesh = make_mesh(n_time, n_chan, [CPU] * (n_time * n_chan))
    key = "synth_wire_raw_ref" if n_chan > 1 else "synth_wire_planes_ref"
    calls = []
    real = getattr(synth, key)
    monkeypatch.setattr(synth, key,
                        lambda *a: calls.append(a[-1]) or real(*a))
    got = torch.cat(synth_epochs_sharded(eb, n, mesh,
                                         nav_gather=True)).numpy()
    np.testing.assert_array_equal(got, want)
    assert calls and all(calls)  # every entry took the gather variant


def test_cli_with_switch_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """Port CLI (plain gather) and JAX CLI (--impl pallas: the gather
    kernel in the interpreter), both with GPS_SDR_SIM_NAV_GATHER=1: same
    bytes, same stderr."""
    monkeypatch.setenv("GPS_SDR_SIM_NAV_GATHER", "1")
    ours, ref = tmp_path / "ours.bin", tmp_path / "ref.bin"
    short = STATIC[:STATIC.index("-d") + 1] + ["0.2"] + \
        STATIC[STATIC.index("-d") + 2:]
    assert main(short + ["-o", str(ours), "--impl", "torch", "--device",
                         "cpu"]) == 0
    err_ours = capsys.readouterr().err
    assert jax_main(short + ["-o", str(ref), "--impl", "pallas"]) == 0
    err_ref = capsys.readouterr().err
    assert ours.read_bytes() == ref.read_bytes()
    assert _strip_stderr(err_ours) == _strip_stderr(err_ref)


def test_switch_is_read_per_call(monkeypatch):
    """run_simulation reads the switch at each call, as the JAX package's
    synth_staged_packed does, so one process runs both variants; it passes
    it to synth_staged_packed as nav_gather."""
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=0.2, samp_freq=1.0e5))
    real = synth.synth_staged_packed
    for switch in ("0", "1"):
        monkeypatch.setenv("GPS_SDR_SIM_NAV_GATHER", switch)
        calls = []
        monkeypatch.setattr(synth, "synth_staged_packed",
                            lambda *a: calls.append(a[-1]) or real(*a))
        run_simulation(scn, io.BytesIO(), batch_epochs=1, log=lambda s: None,
                       impl="torch", device=CPU)
        assert calls and all(g == (switch == "1") for g in calls)
    wire, ca, _ = random_wire(5, n_epochs=2, n_chan=N_CHAN)
    staged = synth.Staged(torch.from_numpy(wire), torch.from_numpy(ca),
                          N_CHAN)
    out = {g: real(staged, N_OUT_RANDOM, 16, nav_gather=g == "1")
           for g in ("0", "1")}
    w, c = staged.wire, staged.ca_words
    assert torch.equal(out["0"], synth.synth_wire_ref(w, c, N_CHAN,
                                                      N_OUT_RANDOM, 16))
    assert torch.equal(out["1"], synth.synth_wire_ref(
        w, c, N_CHAN, N_OUT_RANDOM, 16, nav_gather=True))
    assert not torch.equal(out["0"], out["1"])  # t0 = -1 rows differ


def test_runner_with_switch_writes_walk_bytes(monkeypatch):
    """On a real plan the runner's bytes do not depend on the switch."""
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=0.2, samp_freq=1.0e6,
        data_format=1))
    out = {}
    for switch in ("0", "1"):
        monkeypatch.setenv("GPS_SDR_SIM_NAV_GATHER", switch)
        buf = io.BytesIO()
        run_simulation(scn, buf, batch_epochs=2, log=lambda s: None,
                       impl="torch", device=CPU)
        out[switch] = buf.getvalue()
    assert out["0"] == out["1"]
