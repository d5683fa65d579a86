"""The port stands alone, and its copies match the JAX package exactly.

- Isolation: no module of gps_sdr_sim_tpu_torch and no line of
  chip_smoke.py imports jax or gps_sdr_sim_tpu, even inside a function.
- Host layer: the port's copy (constants, utils, models, ops/plan,
  ops/tables) plans the same scenarios, channel tables and [B, C, 12] wires
  as the JAX package's, byte for byte, and stamps the same scenario_hash.
- The kernel's planes and raw modes: their plain versions equal the Pallas
  kernel's quantize=True/fmt=None and quantize=False variants run in
  interpret mode, and the port's pack_sc16/08/01 equal JAX's.

All arithmetic is integer or the same float64 code, so every comparison is
exact (tolerance zero)."""

import ast
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.constants import R2D
from gps_sdr_sim_tpu.models import scenario as jax_scenario
from gps_sdr_sim_tpu.ops import plan as jax_plan
from gps_sdr_sim_tpu.ops import synth_pallas
from gps_sdr_sim_tpu.ops.quantize import pack as jax_pack
from gps_sdr_sim_tpu.parallel.writer import scenario_hash as jax_scenario_hash
from gps_sdr_sim_tpu.utils import coord as jax_coord
from gps_sdr_sim_tpu.utils.gpstime import DateTime as JaxDateTime
from gps_sdr_sim_tpu_torch.constants import SUBBLOCK
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import plan, synth
from gps_sdr_sim_tpu_torch.ops.quantize import pack
from gps_sdr_sim_tpu_torch.parallel.writer import scenario_hash
from gps_sdr_sim_tpu_torch.testing import (
    DATA,
    NAV,
    ROOT,
    SCENARIOS,
    TOKYO,
    random_wire,
)

# ---------------------------------------------------------------------------
# Isolation.
# ---------------------------------------------------------------------------


def _forbidden(name: str) -> bool:
    """jax, the JAX package, and the repository's root tools and entry
    modules (the port keeps its own copies)."""
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "gps_sdr_sim_tpu", "tools", "__graft_entry__",
                         "bench", "bench_scaling", "deepcheck", "dayrun"))


def test_no_import_of_jax_or_the_jax_package():
    files = sorted((ROOT / "gps_sdr_sim_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    port = ROOT / "gps_sdr_sim_tpu_torch"
    assert {port / "entry.py", port / "tools" / "dayrun.py",
            port / "tools" / "deepcheck.py",
            port / "tools" / "bench.py",
            port / "tools" / "fuzz_oracle.py",
            port / "tools" / "rtk_oracle.py"} <= set(files)
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names
                      if _forbidden(n)]
    assert not found, found


# ---------------------------------------------------------------------------
# Host layer.
# ---------------------------------------------------------------------------

_PARITY = dict(SCENARIOS, circle_2_6=dict(
    motion_file=str(DATA / "circle.csv"), data_format=16))


def _configs(name):
    """(port config, JAX config) of one scenario, each built from its own
    package's types."""
    kw = dict(_PARITY[name])
    rate, dur = (2.6e6, 1.0) if name == "circle_2_6" else (1.0e6, 0.3)
    port = ScenarioConfig(nav_file=str(NAV), duration=dur, samp_freq=rate,
                          **kw)
    if "t0" in kw:
        kw["t0"] = JaxDateTime(**dataclasses.asdict(kw["t0"]))
    return port, jax_scenario.ScenarioConfig(
        nav_file=str(NAV), duration=dur, samp_freq=rate, **kw)


def test_static_position_matches():
    """The golden configurations' static position, from each package's
    own llh2xyz."""
    llh = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
    np.testing.assert_array_equal(jax_coord.llh2xyz(llh), TOKYO)


@pytest.mark.parametrize("name", sorted(_PARITY))
def test_host_layer_matches_jax_package(name):
    port_cfg, jax_cfg = _configs(name)
    ours = build_scenario(port_cfg)
    ref = jax_scenario.build_scenario(jax_cfg)
    assert ours.iq_buff_size == ref.iq_buff_size
    assert ours.n_output_epochs == ref.n_output_epochs
    assert ours.channel_tables == ref.channel_tables
    assert scenario_hash(ours) == jax_scenario_hash(ref)
    assert len(ours.segments) == len(ref.segments)
    batches = 0
    for seg_p, seg_j in zip(ours.segments, ref.segments):
        for e in range(0, seg_p.n_epochs, 4):
            e1 = min(e + 4, seg_p.n_epochs)
            eb_p = plan.plan_epochs(seg_p, e, e1, ours.delt)
            eb_j = jax_plan.plan_epochs(seg_j, e, e1, ref.delt)
            assert eb_p.n_chan == eb_j.n_chan
            assert plan.pack_epoch_wire(eb_p).tobytes() == \
                jax_plan.pack_epoch_wire(eb_j).tobytes()
            assert eb_p.ca_words.tobytes() == eb_j.ca_words.tobytes()
            batches += 1
    assert batches >= 1


# ---------------------------------------------------------------------------
# The planes and raw modes against the Pallas interpreter.
# ---------------------------------------------------------------------------


def _pallas_iq(wire, ca, n_chan, n_out, quantize):
    """The Pallas kernel's I/Q planes (fmt=None), sliced to [B, SB*2048]."""
    sb = -(-n_out // SUBBLOCK)
    tile, sb_pad = synth_pallas._aligned_tile(sb)
    params, _rows = synth_pallas._wire_to_params(jnp.asarray(wire), sb,
                                                 align=True)
    fn = synth_pallas._get_pallas_fn(n_chan, quantize=quantize, uniform=True,
                                     tile_rows=tile)
    B = wire.shape[0]
    return [np.asarray(x).reshape(B, sb_pad, SUBBLOCK)[:, :sb].reshape(B, -1)
            for x in fn(params, jnp.asarray(ca))]


# The interpreter's run time grows with the channel count (~3 s per
# channel on a real wire), so every case keeps a few channels.


@pytest.fixture(scope="module")
def real_wire():
    """Two epochs of a static scenario at 200 ksps (5.1 chips a sample),
    summed over its first 4 active channels."""
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=0.3, samp_freq=2.0e5))
    eb = plan.plan_epochs(scn.segments[0], 0, 2, scn.delt)
    assert eb.n_chan > 4
    return plan.pack_epoch_wire(eb), eb.ca_words, 4, scn.iq_buff_size


_CASES = [("real", None)] + [("random", s) for s in (0, 1)]


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("kind,seed", _CASES)
def test_iq_modes_match_pallas_interpret(real_wire, kind, seed, quantize):
    """Planes: (acc + 64) >> 7 wrapped to int16; raw: the int32 channel
    sums. Seeded wires have t0 = -1 rows and gains up to 400."""
    if kind == "real":
        wire, ca, n_chan, n_out = real_wire
    else:
        wire, ca, n_chan = random_wire(seed, n_chan=3 + seed, max_gain=400)
        n_out = 5000
    ref = synth.synth_wire_planes_ref if quantize else synth.synth_wire_raw_ref
    got = ref(torch.from_numpy(wire), torch.from_numpy(ca), n_chan, n_out)
    want = _pallas_iq(wire, ca, n_chan, n_out, quantize)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int16 if quantize else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w)
    # On the CPU the wrapper is its plain version.
    fn = synth.synth_wire_planes if quantize else synth.synth_wire_raw
    again = fn(torch.from_numpy(wire), torch.from_numpy(ca), n_chan, n_out)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_planes_interleaved_are_the_sc16_words():
    wire, ca, n_chan = random_wire(5, n_epochs=2, max_gain=400)
    w, c = torch.from_numpy(wire), torch.from_numpy(ca)
    i16, q16 = synth.synth_wire_planes(w, c, n_chan, 4100)
    words = synth.synth_wire(w, c, n_chan, 4100, 16)
    np.testing.assert_array_equal(
        torch.stack([i16, q16], dim=-1).numpy(),
        words.numpy().view(np.int16).reshape(2, -1, 2))


@pytest.mark.parametrize("fmt", [16, 8, 1])
def test_pack_matches_jax(fmt):
    """n = 1001 leaves a partial SC01 group, which both drop."""
    rng = np.random.default_rng(fmt)
    iq = rng.integers(-32768, 32768, (2, 1001, 2)).astype(np.int16)
    got = pack(torch.from_numpy(iq), fmt).numpy()
    want = np.asarray(jax_pack(jnp.asarray(iq), fmt))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
