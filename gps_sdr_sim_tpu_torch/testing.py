"""The C-reference IQ goldens and their pass criterion, without JAX.

The same scenarios and thresholds as tests/test_iq_golden.py, for the
port's CPU tests and for chip_smoke.py on a machine that has no JAX. The
goldens (tests/golden/iq_golden.npz) were written by the compiled reference
simulator for 0.3 s / 1 Msps runs. Its float64 NCO accumulates rounding
noise that a closed-form evaluation cannot replicate exactly, so the
criterion is: at most 1e-4 of the samples differ, by at most 4 LSB, plus at
most two isolated chip-boundary flips (SC01: bit-mismatch fraction <= 2e-5).
"""

from __future__ import annotations

import io
import pathlib

import numpy as np

from gps_sdr_sim_tpu.constants import R2D
from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu.utils.coord import llh2xyz
from gps_sdr_sim_tpu.utils.gpstime import DateTime

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


def golden_scenario(name: str):
    """The 0.3 s / 1 Msps scenario the golden `name` was written from."""
    return build_scenario(ScenarioConfig(
        nav_file=str(NAV), duration=0.3, samp_freq=1.0e6, **SCENARIOS[name]))


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
