"""The C-reference IQ goldens and their pass criterion, without JAX.

The same scenarios and thresholds as tests/test_iq_golden.py, for the
port's CPU tests and for chip_smoke.py on a machine that has no JAX. The
goldens (tests/golden/iq_golden.npz) were written by the compiled reference
simulator for 0.3 s / 1 Msps runs. Its float64 NCO accumulates rounding
noise that a closed-form evaluation cannot replicate exactly, so the
criterion is: at most 1e-4 of the samples differ, by at most 4 LSB, plus at
most two isolated chip-boundary flips (SC01: bit-mismatch fraction <= 2e-5).

It also holds the receiver's capture (the static Tokyo scenario at
2.048 Msps, SC16, through the port's runner) and the tolerances to which
the receiver's torch search and loops are held against a reference run.
"""

from __future__ import annotations

import io
import pathlib
import tempfile

import numpy as np

from gps_sdr_sim_tpu_torch.constants import CA_SEQ_LEN, R2D
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.utils.coord import llh2xyz
from gps_sdr_sim_tpu_torch.utils.gpstime import DateTime

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "data"
GOLDEN = ROOT / "tests" / "golden"
NAV = DATA / "brdc3540.14n"

TOKYO = llh2xyz(np.array([35.681298 / R2D, 139.766247 / R2D, 10.0]))

SCENARIOS = {
    "static16": dict(static_xyz=TOKYO, data_format=16),
    "static8": dict(static_xyz=TOKYO, data_format=8),
    "static1": dict(static_xyz=TOKYO, data_format=1),
    "ecef16": dict(static_xyz=np.array([3967283.154, 1022538.181,
                                        4872414.484]), data_format=16),
    "circle16": dict(motion_file=str(DATA / "circle.csv"), data_format=16),
    "gga16": dict(nmea_file=str(DATA / "triumphv3.txt"), data_format=16),
    "rocket16": dict(motion_file=str(DATA / "rocket.csv"), data_format=16,
                     iono_enable=False),
    "t016": dict(static_xyz=TOKYO, data_format=16,
                 t0=DateTime(2014, 12, 20, 1, 23, 45.0)),
    "tow16": dict(static_xyz=TOKYO, data_format=16,
                  t0=DateTime(2026, 8, 16, 0, 0, 0.0), timeoverwrite=True),
    # 32-bit fixed-point carrier NCO (the reference built with
    # FLOAT_CARR_PHASE undefined).
    "staticfix16": dict(static_xyz=TOKYO, data_format=16,
                        carrier_phase_mode="fixed"),
    # 8,000 km altitude: channel gain reaches ~202, the large-gain regime.
    "highalt16": dict(static_xyz=llh2xyz(
        np.array([35.0 / R2D, 139.0 / R2D, 8.0e6])), data_format=16,
        iono_enable=False),
}


def load_goldens() -> dict:
    with np.load(GOLDEN / "iq_golden.npz") as z:
        return {k: z[k] for k in z.files}


def golden_scenario(name: str, duration: float = 0.3):
    """The 0.3 s / 1 Msps scenario the golden `name` was written from, or
    the same configuration over another duration."""
    return build_scenario(ScenarioConfig(
        nav_file=str(NAV), duration=duration, samp_freq=1.0e6,
        **SCENARIOS[name]))


def synthesize(name: str, impl: str, device) -> np.ndarray:
    """The golden scenario through the port's runner, as bytes."""
    from gps_sdr_sim_tpu_torch.runner import run_simulation

    buf = io.BytesIO()
    run_simulation(golden_scenario(name), buf, batch_epochs=4,
                   log=lambda s: None, impl=impl, device=device)
    return np.frombuffer(buf.getvalue(), dtype=np.uint8)


def check(ours: np.ndarray, ref: np.ndarray, data_format: int) -> None:
    """Raise AssertionError unless `ours` meets the golden criterion."""
    if ours.size != ref.size:
        raise AssertionError(f"size {ours.size} != golden {ref.size}")
    if data_format == 1:
        a = np.unpackbits(ours)
        b = np.unpackbits(ref)
        frac = np.count_nonzero(a != b) / a.size
        if frac > 2e-5:
            raise AssertionError(f"bit mismatch fraction {frac}")
        return
    dtype = np.int16 if data_format == 16 else np.int8
    a = ours.view(dtype).astype(np.int32)
    b = ref.view(dtype).astype(np.int32)
    d = np.abs(a - b)
    small = np.count_nonzero(d)
    big = np.count_nonzero(d > 8)
    if small / d.size > 1e-4:
        raise AssertionError(f"mismatch fraction {small / d.size}")
    if big > 2:
        raise AssertionError(f"{big} chip-flip-scale mismatches")
    if d[d <= 8].max(initial=0) > 4:
        raise AssertionError(f"max small |delta| {d[d <= 8].max()} > 4")


def random_wire(seed, n_epochs=2, n_chan=None, max_gain=131):
    """A [B, 16, 12] wire with fields in the planner's domain, and C/A words.

    t0 = -1 on some channels makes T = -1 at the epoch's first sample;
    m0 a multiple of 20 there makes mg = -1 as well."""
    rng = np.random.default_rng(seed)
    B, C = n_epochs, 16
    n_chan = int(rng.integers(1, C + 1)) if n_chan is None else n_chan
    f56 = 1 << 56
    code_f = rng.integers(0, f56, (B, C), dtype=np.int64)
    # 0.38..1.03 chips/sample: 1.0 to ~2.7 Msps
    code_s = rng.integers(int(0.38 * f56), int(1.03 * f56), (B, C),
                          dtype=np.int64)
    carr_f = rng.integers(0, f56, (B, C), dtype=np.int64)
    carr_s = rng.integers(0, f56, (B, C), dtype=np.int64)
    t0 = rng.integers(0, 1023, (B, C)).astype(np.int32)
    m0 = rng.integers(0, 35900, (B, C)).astype(np.int32)
    neg = rng.random((B, C)) < 0.4
    t0[neg] = -1
    m0[neg] -= m0[neg] % 20
    b0 = m0 // 20
    wire = np.empty((B, C, 12), np.int32)
    for lane, v in ((0, code_f), (2, code_s), (4, carr_f), (6, carr_s)):
        wire[..., lane:lane + 2] = v.view(np.int32).reshape(B, C, 2)
    wire[..., 8] = t0
    wire[..., 9] = m0 | (b0 << 16)
    wire[..., 10] = rng.integers(0, 256, (B, C))
    wire[..., 11] = rng.integers(0, max_gain + 1, (B, C))
    ca = rng.integers(-(1 << 31), 1 << 31, (C, 32), dtype=np.int64)
    return wire, ca.astype(np.int32), n_chan


# ---------------------------------------------------------------------------
# Receiver.
# ---------------------------------------------------------------------------

RX_FS = 2.048e6
# The receiver's search and loops against a reference run of the same
# inputs (the JAX package's on the CPU, or the port's on another device).
# In a closed loop float32 rounding differences grow with time, so these
# hold over short windows (~2 s) at 2.048 Msps only; longer runs are held to
# bits, subframes and fixes.
SEARCH_RTOL = 1e-4
TRACK_PROMPT_REL = 1e-4      # of max |prompt|
TRACK_DOPPLER_HZ = 0.01
TRACK_CODE_PHASE_CHIP = 1e-3


# The RTK closure's rover, ~32 m from TOKYO (tests/test_receiver_rtk.py).
RX_ROVER = llh2xyz(np.array([(35.681298 + 0.00020) / R2D,
                             (139.766247 + 0.00025) / R2D, 12.0]))


def rx_scenario(duration: float, xyz=TOKYO, fs: float = RX_FS):
    """The receiver's static scenario: `xyz`, `fs` (2.048 Msps), SC16."""
    return build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=xyz, duration=duration,
        samp_freq=fs, data_format=16))


def rx_capture(scn, impl: str, device) -> np.ndarray:
    """The scenario through the port's runner, as complex64 baseband."""
    from gps_sdr_sim_tpu_torch.receiver.frontend import load_iq
    from gps_sdr_sim_tpu_torch.runner import run_simulation

    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=16, log=lambda s: None, impl=impl,
                   device=device)
    return load_iq(buf.getvalue(), 16)


def check_search(got, want) -> float:
    """(peak, flat argmax, mean) of two searches: argmax equal, peak and
    mean within SEARCH_RTOL. Returns the largest relative difference."""
    peak, arg, mean = (np.asarray(a) for a in got)
    w_peak, w_arg, w_mean = (np.asarray(a) for a in want)
    if not np.array_equal(arg, w_arg):
        raise AssertionError(f"argmax differs at PRN rows "
                             f"{np.flatnonzero(arg != w_arg).tolist()}")
    rel = max(float(np.max(np.abs(a / b - 1)))
              for a, b in ((peak, w_peak), (mean, w_mean)))
    if rel > SEARCH_RTOL:
        raise AssertionError(f"peak/mean relative difference {rel}")
    return rel


def check_acquisition(got, want) -> float:
    """Two AcqResult lists: prn, detected, code_phase and doppler equal,
    metric within SEARCH_RTOL. Returns the largest relative metric
    difference."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} results != {len(want)}")
    rel = 0.0
    for a, b in zip(got, want):
        if (a.prn, a.detected, a.code_phase, a.doppler) != \
                (b.prn, b.detected, b.code_phase, b.doppler):
            raise AssertionError(f"{a} != {b}")
        rel = max(rel, abs(a.metric / b.metric - 1))
    if rel > SEARCH_RTOL:
        raise AssertionError(f"metric relative difference {rel}")
    return rel


def check_tracking(got, want) -> dict:
    """Two TrackResults of the same channels and samples: prompt within
    TRACK_PROMPT_REL of max |prompt|, Doppler and code phase (modulo one
    code period) within their tolerances, and the prompt's in-phase sign
    (the nav bit) the same at every ms. Returns the measured
    differences."""
    if not np.array_equal(got.prns, want.prns) or \
            got.prompt.shape != want.prompt.shape:
        raise AssertionError(f"channels {got.prns} {got.prompt.shape} != "
                             f"{want.prns} {want.prompt.shape}")
    err = dict(
        prompt_rel=float(np.max(np.abs(got.prompt - want.prompt))
                         / np.max(np.abs(want.prompt))),
        doppler_hz=float(np.max(np.abs(got.doppler - want.doppler))),
        code_phase_chip=float(np.max(np.abs(
            (got.code_phase - want.code_phase + CA_SEQ_LEN / 2) % CA_SEQ_LEN
            - CA_SEQ_LEN / 2))),
        sign_flips=int(np.count_nonzero(np.sign(got.prompt.real)
                                        != np.sign(want.prompt.real))))
    bad = [k for k, tol in (("prompt_rel", TRACK_PROMPT_REL),
                            ("doppler_hz", TRACK_DOPPLER_HZ),
                            ("code_phase_chip", TRACK_CODE_PHASE_CHIP),
                            ("sign_flips", 0)) if err[k] > tol]
    if bad:
        raise AssertionError(f"tracking differs beyond tolerance in {bad}: "
                             f"{err}")
    return err


def receiver_devices_agree(x: np.ndarray, device, ref="cpu") -> dict:
    """The receiver on `device` against the same functions on `ref`, on x
    (about 2 s at RX_FS): the search of all 32 PRNs at 50 Hz steps,
    acquire()'s results, and track() from ref's acquisition. Raises
    AssertionError beyond the tolerances above; returns the measured
    differences."""
    import torch

    from gps_sdr_sim_tpu_torch.receiver.acquire import (
        acquire,
        search,
        search_prep,
    )
    from gps_sdr_sim_tpu_torch.receiver.track import track

    _, _, codes, dopp, xb = search_prep(x, RX_FS, None, 5000.0, 50.0, 4)
    code_fft = np.fft.fft(codes, axis=-1).astype(np.complex64)
    runs = [[a.cpu().numpy() for a in search(
        *(torch.from_numpy(v).to(d) for v in (xb, code_fft, dopp)), RX_FS)]
        for d in (device, ref)]
    err = dict(search_rel=check_search(*runs))
    want = acquire(x, RX_FS, dopp_step=50.0, device=ref)
    err["metric_rel"] = check_acquisition(
        acquire(x, RX_FS, dopp_step=50.0, device=device), want)
    err.update(check_tracking(track(x, RX_FS, want, device=device),
                              track(x, RX_FS, want, device=ref)))
    err["channels"] = sum(a.detected for a in want)
    return err


def mxu_devices_agree(x: np.ndarray, fs: float, device, ref="cpu") -> dict:
    """acquire_mxu's int8 search (all 32 PRNs, +-5 kHz at 50 Hz steps, 4
    blocks of 1 ms) and its AcqResults on `device` against `ref`, on x at
    fs. Raises AssertionError beyond SEARCH_RTOL; returns the largest
    relative differences and the detected channels."""
    from gps_sdr_sim_tpu_torch.receiver.acquire import search_prep
    from gps_sdr_sim_tpu_torch.receiver.acquire_mxu import (
        acquire_mxu,
        search_inputs,
        search_mxu,
    )

    _, _, codes, dopp, xb = search_prep(x, fs, None, 5000.0, 50.0, 4)
    runs = [[a.cpu().numpy() for a in search_mxu(
        *search_inputs(xb, codes, dopp, d), fs)] for d in (device, ref)]
    err = dict(search_rel=check_search(*runs))
    want = acquire_mxu(x, fs, dopp_step=50.0, device=ref)
    err["metric_rel"] = check_acquisition(
        acquire_mxu(x, fs, dopp_step=50.0, device=device), want)
    err["channels"] = sum(a.detected for a in want)
    return err


# The receiver CLI's two stdout tables.
RX_ACQ_HEADER = "PRN  doppler[Hz]  code_phase[samp]  metric"
RX_TRACK_HEADER = ("PRN  doppler[Hz]  C/N0[dBHz]  subframes  TOW[s]        "
                   "week")


def rx_table(stdout: str, header: str = RX_ACQ_HEADER) -> list:
    """The rows (split on blanks) under `header` up to the next blank line
    of the receiver CLI's stdout."""
    lines = stdout.splitlines()
    rows = []
    for line in lines[lines.index(header) + 1:]:
        if not line.strip():
            break
        rows.append(line.split())
    return rows


def rtk_baseline(base, rover, base_xyz=TOKYO, frames=None):
    """The RTK closure of two TrackResults: the base written as RINEX obs
    (1 s epochs) and its decoded ephemerides as RINEX nav (`frames`: the
    base's channel_frames, if already decoded), then rtk_from_files."""
    from gps_sdr_sim_tpu_torch.receiver.rinex import write_nav, write_obs

    with tempfile.TemporaryDirectory() as tmp:
        obs, nav = pathlib.Path(tmp) / "base.obs", pathlib.Path(tmp) / "rx.nav"
        with open(obs, "w") as fp:
            write_obs(fp, base, frames=frames, interval=1.0,
                      approx_xyz=base_xyz)
        with open(nav, "w") as fp:
            write_nav(fp, base, frames=frames)
        return rtk_from_files(rover, obs, nav, base_xyz)


def rtk_from_files(rover, base_obs, nav, base_xyz=TOKYO):
    """The rover TrackResult written as RINEX obs (1 s epochs), read back
    and solved as a double-difference baseline against the base's RINEX
    obs and nav files with the base known."""
    from gps_sdr_sim_tpu_torch.models.ephemeris import (
        IonoUtc,
        read_rinex_nav_all,
    )
    from gps_sdr_sim_tpu_torch.receiver.rinex import write_obs
    from gps_sdr_sim_tpu_torch.receiver.rinexobs import read_rinex_obs
    from gps_sdr_sim_tpu_torch.receiver.rtk import solve_baseline

    obs_r = io.StringIO()
    write_obs(obs_r, rover, interval=1.0)
    eph, _ = read_rinex_nav_all(str(nav), IonoUtc())
    return solve_baseline(read_rinex_obs(io.StringIO(obs_r.getvalue())),
                          read_rinex_obs(str(base_obs)),
                          {k + 1: eph[0][k] for k in range(32)
                           if eph[0][k].vflg}, base_xyz=base_xyz)
