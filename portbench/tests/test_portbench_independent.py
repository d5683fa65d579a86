"""The plain reference against witnesses that share none of its code.

Most of the reference is a frozen copy of the port's host layer, so its
agreement with the port says nothing about a fault the two share. Two
witnesses stand apart from it:

- the upstream C program's output (gpssim.c, compiled from the upstream
  source; the streams in data/c_golden.npz: 0.3 s at 1 Msps of the circle
  run and of a static position, SC16 and SC01, with the same RINEX file and
  trajectory as the cells). It covers the whole chain: ephemeris, orbits,
  observables, channel allocation, navigation message, plan, synthesis and
  packing. The C program's float64 NCOs gather rounding noise that the
  closed form does not reproduce, so the comparison allows the few
  near-boundary flips that it brings, as the port's own golden test does;
- gpssim.c's per-sample loop (its lines 2192-2252) stated again in float64
  from the scenario's epoch-start phases and rates, at the cells' own
  2.6 Msps over whole epochs of each configuration: every sample's C/A
  chip, carrier table index and navigation bit from the reference's
  fixed-point plan equal the loop's, except where the loop's phase lies
  within the plan's stated budget of a boundary.
"""

import json

import numpy as np
import pytest
import torch

from portbench.reference import scenario as rs
from portbench.reference import synth as rsyn
from portbench.reference.constants import CA_SEQ_LEN, R2D, SUBBLOCK
from portbench.reference.plan import plan_epochs
from portbench.tests.conftest import REPO

DATA = REPO / "portbench" / "data"
TOKYO = rs.llh2xyz(np.array([35.681298 / R2D, 139.766247 / R2D, 10.0]))
GOLDEN = {"circle16": (dict(motion_file=str(DATA / "circle.csv")), 16),
          "static16": (dict(static_xyz=TOKYO), 16),
          "static1": (dict(static_xyz=TOKYO), 1)}


def _golden_scenario(name, precision="float64"):
    kw, fmt = GOLDEN[name]
    cfg = rs.ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                            duration=0.3, samp_freq=1.0e6, data_format=fmt,
                            **kw)
    scn = rs.build_scenario(cfg)
    return np.frombuffer(b"".join(
        rsyn.epoch_bytes(scn, e, "cpu", fmt, precision)
        for e in range(scn.n_output_epochs)), np.uint8)


def _near_c(ours: np.ndarray, ref: np.ndarray, fmt: int) -> bool:
    """Within the C program's float64 NCO noise: at most 1e-4 of the
    samples differ, by at most 4 LSB, but for two chip flips (SC01: at
    most 2e-5 of the bits)."""
    if ours.size != ref.size:
        return False
    if fmt == 1:
        a, b = np.unpackbits(ours), np.unpackbits(ref)
        return np.count_nonzero(a != b) / a.size <= 2e-5
    d = np.abs(ours.view(np.int16).astype(np.int32)
               - ref.view(np.int16).astype(np.int32))
    return (np.count_nonzero(d) / d.size <= 1e-4
            and np.count_nonzero(d > 8) <= 2
            and d[d <= 8].max(initial=0) <= 4)


@pytest.fixture(scope="module")
def c_golden():
    return np.load(DATA / "c_golden.npz")


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_reference_against_the_c_program(c_golden, name):
    ours = _golden_scenario(name)
    assert ours.size == c_golden[name].size
    assert _near_c(ours, c_golden[name], GOLDEN[name][1])


def test_the_c_comparison_refuses_the_control(c_golden):
    # The float32 control reads as far from the C program as from the
    # reference: the comparison above has room for noise, not for it.
    ours = _golden_scenario("circle16", precision="float32")
    assert not _near_c(ours, c_golden["circle16"], 16)


# How far the two may part at sample k: the plan's in-sub-block ramp drops
# the step's low 16 of 56 fractional bits (< 2^11 * 2^-40 = 2^-29), and
# each of the loop's k float64 adds rounds by up to half an ulp (2^-44 for
# a code phase under 1024 chips, 2^-54 for a carrier phase under 1 cycle):
# the C program's own NCO noise, about 1e-8 chips over an epoch.
def _budget(k, half_ulp):
    return 2.0 ** -29 + (np.asarray(k) + 1) * half_ulp


def _nco_loop(cp, fc, carr, fcarr, windows):
    """gpssim.c's per-sample update (code: += f_code * delt, wrap at
    1023 chips; carrier: += f_carr * delt, wrap into [0, 1)) on arrays
    of channels; returns, for each sample of `windows`, the code phase in
    chips, the code periods wrapped since the start, and the carrier
    phase in cycles."""
    want = sorted({k for lo, hi in windows for k in range(lo, hi)})
    out = {k: None for k in want}
    wraps = np.zeros(cp.shape, np.int64)
    cp, carr = cp.copy(), carr.copy()
    for k in range(want[-1] + 1):
        if k in out:
            out[k] = (cp.copy(), wraps.copy(), carr.copy())
        cp += fc
        w = cp >= CA_SEQ_LEN
        cp[w] -= CA_SEQ_LEN
        wraps += w
        carr += fcarr
        carr[carr >= 1.0] -= 1.0
        carr[carr < 0.0] += 1.0
    return want, out


def _config(name):
    return json.loads((REPO / "portbench" / "configs" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("config", ["circle300", "static300"])
def test_plan_against_a_per_sample_nco(config):
    from portbench.drivers.epoch_range import scenario_config

    traffic = json.loads((REPO / "portbench" / "traffic" /
                          "sc16.sharded.json").read_text())
    cfg = _config(config)
    scn = rs.build_scenario(scenario_config(rs, cfg, traffic, REPO))
    n = scn.iq_buff_size
    # The first, a middle and the last epoch, each over its first two
    # sub-blocks, its middle and its last samples.
    windows = [(0, 2 * SUBBLOCK + 50), (n // 2 - 1100, n // 2 + 1100),
               (n - 2 * SUBBLOCK - 50, n)]
    checked = exempt = 0
    for epoch in (0, scn.n_output_epochs // 2, scn.n_output_epochs - 1):
        seg, e = rsyn.locate(scn, epoch)
        act = np.flatnonzero(seg.active)
        eb = plan_epochs(seg, e, e + 1, scn.delt, compact=False)
        want, loop = _nco_loop(
            seg.code_phase0[e, act].copy(), seg.f_code[e, act] * scn.delt,
            seg.carr_phase0[e, act].copy(), seg.f_carr[e, act] * scn.delt,
            windows)
        k = torch.tensor(want, dtype=torch.int64)[None]
        r = k % SUBBLOCK

        def col(a):
            return torch.from_numpy(a[0, act].astype(np.int64))[:, None]

        whole, code = rsyn._at_sample(col(eb.code_f), col(eb.code_s),
                                      k - r, r)
        T = (col(eb.t0) + whole + (code >> 40)).numpy()
        _, carr = rsyn._at_sample(col(eb.carr_f), col(eb.carr_s), k - r, r)
        idx = ((carr >> 31) & 0x1FF).numpy()
        m0 = col(eb.m0).numpy()
        j = (m0 - 20 * col(eb.b0).numpy() + T // CA_SEQ_LEN) // 20
        nav = (col(eb.navbits).numpy() >> np.clip(j, 0, 31)) & 1
        cp = np.stack([loop[s][0] for s in want], axis=1)
        wraps = np.stack([loop[s][1] for s in want], axis=1)
        cr = np.stack([loop[s][2] for s in want], axis=1)
        # The phases themselves, unwrapped, within the budget.
        tol_code = _budget(want, 2.0 ** -44)[None]
        tol_carr = _budget(want, 2.0 ** -54)[None]
        frac = (code & ((1 << 40) - 1)).numpy() / 2.0 ** 40
        assert np.all(np.abs((T + frac) - (cp + CA_SEQ_LEN * wraps))
                      < tol_code)
        cfrac = (carr & ((1 << 40) - 1)).numpy() / 2.0 ** 40
        dc = np.abs(cfrac - cr)
        assert np.all(np.minimum(dc, 1 - dc) < tol_carr)
        # Chips, table indices and nav bits, away from their boundaries.
        sure = (np.abs(cp - np.rint(cp)) > tol_code) & \
            (np.abs(cr * 512 - np.rint(cr * 512)) > 512 * tol_carr)
        chip = T - CA_SEQ_LEN * (T // CA_SEQ_LEN)
        assert np.array_equal(chip[sure], np.floor(cp).astype(np.int64)[sure])
        assert np.array_equal(idx[sure],
                              np.floor(cr * 512).astype(np.int64)[sure])
        bit_idx = (m0 + wraps) // 20
        assert np.all((0 <= j) & (j <= 31))
        bits01 = (seg.bits[act].astype(np.int64) + 1) // 2
        want_nav = np.take_along_axis(bits01, bit_idx, axis=1)
        assert np.array_equal(nav[sure], want_nav[sure])
        checked += sure.sum()
        exempt += (~sure).sum()
    assert checked > 100_000 and exempt < checked // 1000
