"""Double-difference carrier-phase baseline solver (software RTKLIB).

The strongest correctness evidence the reference ships is `rtk/`
(SURVEY.md §2.3/§4): two simulated datasets captured on a u-blox
receiver, RTKCONV'd to RINEX, and post-processed with RTKLIB to a
carrier-phase differential fix (`/root/reference/rtk/base.obs`,
`rtk/rtklib/rtkpost.png`). That chain proves the synthesized L1 carrier
is phase-coherent across receivers — something no pseudorange test can
show. This module reproduces the RTKLIB step in software: it consumes
the RINEX obs pair + nav file written by receiver/rinex.py and solves
the base→rover baseline from double-differenced carrier phase.

Model. For receiver r and satellite s the transmit instant is exact:
tx = t_obs − C1/c is the SV time stamp of the received sample, and the
SV clock correction from the nav message moves it onto GPS time. The
phase-range is then purely geometric — c·(flight time) =
|R(ω·τ)·p_sat(tx) − x_r| — with no receiver or satellite clock anywhere
in it, so single differences across receivers cancel the satellite
phase origin and double differences cancel everything but geometry and
the carrier ambiguity.

Ambiguities are HALF-integers here, not integers: the receiver's Costas
PLL (receiver/track.py) locks its NCO to the carrier modulo half
cycles (the 180° data ambiguity), and receiver/rinex.py writes the
absolute NCO phase. The solver therefore fixes ambiguities in units of
λ/2. This mirrors the half-cycle flag RTKLIB carries for the same
reason. (The half-integer structure also relies on base and rover
scenarios allocating channels at the same epochs, which holds for the
bundled static validation scenes — when it does not, the float solution
is still valid and the fix simply fails validation.)
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from gps_sdr_sim_tpu_torch.constants import (LAMBDA_L1, OMEGA_EARTH, R2D,
                                       SPEED_OF_LIGHT)
from gps_sdr_sim_tpu_torch.models.ephemeris import eph_field_arrays
from gps_sdr_sim_tpu_torch.models.orbit import satpos
from gps_sdr_sim_tpu_torch.receiver.ambiguity import ils_solve
from gps_sdr_sim_tpu_torch.receiver.rinexobs import ObsData
from gps_sdr_sim_tpu_torch.utils.coord import (ecef2neu, ltcmat, neu2azel,
                                         xyz2llh)

@dataclass
class RtkSolution:
    baseline: np.ndarray       # rover − base, ECEF meters (fixed if fixed)
    baseline_float: np.ndarray  # float solution baseline
    fixed: bool                # half-cycle ambiguities fixed & validated
    ref_prn: int
    prns: np.ndarray           # non-reference satellites, DD order
    amb_float: np.ndarray      # float DD ambiguities (half cycles)
    amb_frac: float            # worst |float − fixed| (half cycles)
    ratio: float               # ILS ratio test (2nd best / best)
    phase_rms: float           # DD phase residual RMS of the reported
    #                            solution (meters)
    n_epochs: int
    n_sats: int                # incl. the reference satellite
    base_xyz: np.ndarray = None  # the base anchor actually used
    # Kinematic mode only (RTKLIB positioning mode "kinematic"; the
    # reference's rtk/rover.csv ground-track scenario): per-epoch rover
    # baselines and their GPS seconds-of-week time tags. `baseline` is
    # then the mean over epochs.
    baselines: Optional[np.ndarray] = None   # [K, 3]
    times: Optional[np.ndarray] = None       # [K] SOW
    # Cycle slips detected (Doppler check: physical per-satellite events;
    # residual fallback: per-DD-column breaks). Each re-initializes the
    # affected ambiguity from that epoch on.
    n_slips: int = 0


def _segment_ambiguities(col_break: np.ndarray):
    """Per-column ambiguity segmentation from break flags.

    col_break[k-1, j] marks a new ambiguity for DD column j starting at
    epoch k (a cycle slip between epochs k-1 and k — RTKLIB re-initializes
    the slipped ambiguity the same way). Returns (amb_idx [K, S-1], n_amb).
    """
    km1, sm1 = col_break.shape
    amb_idx = np.zeros((km1 + 1, sm1), np.intp)
    n = 0
    for j in range(sm1):
        cur = n
        n += 1
        amb_idx[0, j] = cur
        for k in range(1, km1 + 1):
            if col_break[k - 1, j]:
                cur = n
                n += 1
            amb_idx[k, j] = cur
    return amb_idx, n


def _sat_states(eph_objs: Sequence, t_obs: np.ndarray, c1: np.ndarray):
    """Satellite ECEF position at the exact transmit instant of each
    observation, plus the applied SV clock offset.

    t_obs, c1: [K, S]; returns pos [K, S, 3].
    """
    eph = eph_field_arrays(list(eph_objs))
    tx_sv = t_obs - c1 / SPEED_OF_LIGHT
    pos = np.empty(t_obs.shape + (3,))
    for k in range(t_obs.shape[0]):
        _, _, clk = satpos(eph, tx_sv[k])
        tx_gps = tx_sv[k] - clk[..., 0]
        pos[k], _, _ = satpos(eph, tx_gps)
    return pos


def _rho_e(x: np.ndarray, pos: np.ndarray):
    """Geometric range and unit LOS with Sagnac (flight-time fixed point).

    The Earth-rotation correction is the same rotation the generator
    applies (models/observables.py; gpssim.c:1276-1280), iterated on the
    flight time so the model is exact for either receiver regardless of
    its clock offset.
    """
    tau = np.linalg.norm(pos - x, axis=-1) / SPEED_OF_LIGHT
    for _ in range(2):
        ang = OMEGA_EARTH * tau
        ca, sa = np.cos(ang), np.sin(ang)
        p_rot = np.stack([ca * pos[..., 0] + sa * pos[..., 1],
                          -sa * pos[..., 0] + ca * pos[..., 1],
                          pos[..., 2]], axis=-1)
        rho = np.linalg.norm(p_rot - x, axis=-1)
        tau = rho / SPEED_OF_LIGHT
    return rho, (p_rot - x) / rho[..., None]


def _spp(eph_objs, t_obs_row, c1_row) -> np.ndarray:
    """Single-point position from one epoch's pseudoranges (for the
    linearization point / unknown base); reuses the PVT solver."""
    from gps_sdr_sim_tpu_torch.receiver.pvt import ChannelObs, solve

    chans = [ChannelObs(prn=0, tx_time=t - r / SPEED_OF_LIGHT, eph=e)
             for e, t, r in zip(eph_objs, t_obs_row, c1_row)]
    return solve(chans).xyz


def solve_baseline(rover: ObsData, base: ObsData,
                   eph_by_prn: Dict[int, object],
                   base_xyz: Optional[np.ndarray] = None,
                   sigma_phase: float = 0.003, sigma_code: float = 3.0,
                   ratio_threshold: float = 3.0,
                   kinematic: bool = False) -> RtkSolution:
    """Double-difference baseline from a RINEX obs pair + nav.

    eph_by_prn: decoded/parsed Ephemeris per PRN (e.g. from
    models/ephemeris.read_rinex_nav_all on the receiver's own nav file).
    base_xyz anchors the base (RTKLIB's "base station position"); when
    None it is single-point estimated, which degrades the baseline only
    by the ~meter SPP error projected through the <1e-4 rad geometry
    difference (RTKLIB does the same with its rtkpost "Average of
    single position" option).

    kinematic=True is RTKLIB's "kinematic" positioning mode (the
    reference's rtk/rover.csv moving-rover dataset): one position
    unknown per epoch, ambiguities still constant over the window —
    they are what ties the track together. The per-epoch fixed
    baselines land in `solution.baselines`.
    """
    by_t_rov = {round(e.t.week * 604800.0 + e.t.sec, 6): e
                for e in rover.epochs}
    by_t_base = {round(e.t.week * 604800.0 + e.t.sec, 6): e
                 for e in base.epochs}
    common_t = sorted(set(by_t_rov) & set(by_t_base))
    if len(common_t) < 2:
        raise ValueError("fewer than 2 common epochs between rover and "
                         "base obs")

    # Satellites present with C1+L1 in every common epoch of both files
    # (static scenes keep a constant constellation; anything transient
    # would need per-epoch bookkeeping and cycle-slip handling).
    sats = None
    for t in common_t:
        here = {p for p, v in by_t_rov[t].obs.items()
                if "C1" in v and "L1" in v}
        here &= {p for p, v in by_t_base[t].obs.items()
                 if "C1" in v and "L1" in v}
        sats = here if sats is None else (sats & here)
    sats = sorted(p for p in sats if p in eph_by_prn
                  and not getattr(eph_by_prn[p], "svhlth", 0))
    if len(sats) < 4:
        raise ValueError(f"need >=4 common satellites, got {len(sats)}")

    K, S = len(common_t), len(sats)
    eph_objs = [eph_by_prn[p] for p in sats]
    sow = np.array([t % 604800.0 for t in common_t])

    def grid(by_t, typ):
        return np.array([[by_t[t].obs[p][typ] for p in sats]
                         for t in common_t])

    c1_r, l1_r = grid(by_t_rov, "C1"), grid(by_t_rov, "L1")
    c1_b, l1_b = grid(by_t_base, "C1"), grid(by_t_base, "L1")

    t_obs = np.broadcast_to(sow[:, None], (K, S))
    pos_r = _sat_states(eph_objs, t_obs, c1_r)
    pos_b = _sat_states(eph_objs, t_obs, c1_b)

    if base_xyz is None:
        base_xyz = _spp(eph_objs, t_obs[0], c1_b[0])
    base_xyz = np.asarray(base_xyz, float)

    # Rover position unknowns: one shared (static) or one per epoch
    # (kinematic). `x` is always [P, 3]; `pk[k]` maps epoch -> block.
    P = K if kinematic else 1
    pk = np.arange(K) if kinematic else np.zeros(K, np.intp)
    if kinematic:
        x = np.stack([_spp(eph_objs, t_obs[k], c1_r[k]) for k in range(K)])
    else:
        x = _spp(eph_objs, t_obs[0], c1_r[0])[None]

    # Reference satellite: highest elevation seen from the base.
    azel = neu2azel(ecef2neu(pos_b[0] - base_xyz,
                             ltcmat(xyz2llh(base_xyz))))
    ref = int(np.argmax(azel[..., 1]))
    oth = [j for j in range(S) if j != ref]

    def dd(a: np.ndarray) -> np.ndarray:
        """[K, S] zero-difference → [K, S-1] double difference."""
        sd = a[:, oth] - a[:, [ref]]
        return sd

    # Observed DDs: rover−base across receivers, then minus the ref sat.
    dd_code = dd(c1_r - c1_b)
    dd_phase = dd(LAMBDA_L1 * (l1_r - l1_b))
    rho_b, _ = _rho_e(base_xyz, pos_b)

    w_ph, w_cd = 1.0 / sigma_phase, 1.0 / sigma_code
    half = LAMBDA_L1 / 2.0
    n_dd = K * (S - 1)
    rows = np.arange(n_dd)  # row-major [k, j] -> ambiguity j

    def model(x):
        """DD model + geometry rows for the current positions [P, 3]."""
        rho_r, e_r = _rho_e(x[pk][:, None, :], pos_r)
        # ∂DD/∂x_rov: only the rover ranges depend on x.   [K, S-1, 3]
        return dd(rho_r - rho_b), -(e_r[:, oth] - e_r[:, [ref]])

    # Geometry columns: scatter rows into each epoch's position block
    # (the static case collapses to two dense [n_dd, 3] column blocks).
    cols = (3 * pk[:, None] + np.arange(3))[:, None, :]       # [K,1,3]
    cols = np.broadcast_to(cols, (K, S - 1, 3)).reshape(n_dd, 3)
    x0 = x.copy()

    def float_solve(amb_idx, n_amb):
        """Iterated LS over positions + (possibly segmented) ambiguities.

        amb_idx[k, j] maps each DD observation to its ambiguity column —
        one per satellite normally; a cycle slip opens a fresh column
        from that epoch on (RTKLIB re-initializes the slipped ambiguity
        the same way)."""
        x = x0.copy()
        amb = np.zeros(n_amb)
        acol = 3 * P + amb_idx.reshape(-1)
        for _ in range(4):
            dd_model, H_geo = model(x)
            r_ph = (dd_phase - dd_model - half * amb[amb_idx])  # [K, S-1]
            r_cd = (dd_code - dd_model)

            A = np.zeros((2 * n_dd, 3 * P + n_amb))
            b = np.empty(2 * n_dd)
            A[rows[:, None], cols] = H_geo.reshape(n_dd, 3) * w_ph
            A[rows, acol] = half * w_ph
            b[:n_dd] = r_ph.reshape(-1) * w_ph
            A[n_dd + rows[:, None], cols] = H_geo.reshape(n_dd, 3) * w_cd
            b[n_dd:] = r_cd.reshape(-1) * w_cd
            d, *_ = np.linalg.lstsq(A, b, rcond=None)
            x = x + d[:3 * P].reshape(P, 3)
            amb = amb + d[3 * P:]
            if np.linalg.norm(d[:3 * P]) < 1e-4:
                break
        dd_model, _ = model(x)
        return x, amb, A, dd_phase - dd_model - half * amb[amb_idx]

    # Cycle-slip detection. Primary: Doppler consistency per receiver and
    # satellite BEFORE any fit (RTKLIB's detslp_dop): the integrated-phase
    # step between epochs must match the trapezoidal Doppler prediction
    # (writer convention dL1/dt = -D1, receiver/rinex.py, which writes the
    # block-centered window-averaged Doppler — the raw per-block NCO
    # frequency mispredicts by up to ~1 cycle). A half-cycle slip is a
    # 0.5-cycle outlier against measured prediction noise of ~0.04 cycles
    # rms / 0.19 max (26 s static AND circle-trajectory captures).
    # Geometry-free, so it works identically in static and kinematic mode
    # (a post-fit residual test is blind in kinematic geometry: the
    # per-epoch position unknowns absorb the step when few satellites are
    # in view). A slip on the REFERENCE satellite re-initializes every DD
    # column but counts as the one physical event it is.
    def dopp_slips(by_t):
        """[K-1, S] slip flags from one receiver's L1/D1, or None."""
        if any("D1" not in by_t[t].obs[p] for t in common_t for p in sats):
            return None
        d1 = np.array([[by_t[t].obs[p]["D1"] for p in sats]
                       for t in common_t])
        l1 = np.array([[by_t[t].obs[p]["L1"] for p in sats]
                       for t in common_t])
        dt = np.diff(sow)[:, None]
        pred = -0.5 * (d1[1:] + d1[:-1]) * dt
        return np.abs(np.diff(l1, axis=0) - pred) > 0.25

    n_slips = 0
    amb_idx = np.broadcast_to(np.arange(S - 1), (K, S - 1)).copy()
    n_amb = S - 1
    sl_r, sl_b = dopp_slips(by_t_rov), dopp_slips(by_t_base)
    if sl_r is not None and sl_b is not None:
        sl = sl_r | sl_b                                  # [K-1, S]
        n_slips = int(sl.sum())
        if n_slips:
            amb_idx, n_amb = _segment_ambiguities(sl[:, oth] | sl[:, [ref]])
        x_float, amb, A, res_float = float_solve(amb_idx, n_amb)
    else:
        # Fallback without Doppler observables: step test on the float
        # DD residual series (a slip is a >= lambda/2 ~ 9.5 cm step
        # against millimetric slip-free scatter). Static geometry only —
        # see the kinematic caveat above.
        x_float, amb, A, res_float = float_solve(amb_idx, n_amb)
        if K >= 3 and not kinematic:
            steps = np.abs(np.diff(res_float, axis=0)) > 0.04
            if steps.any():
                amb_idx, n_amb = _segment_ambiguities(steps)
                n_slips = int(steps.sum())
                x_float, amb, A, res_float = float_solve(amb_idx, n_amb)

    phase_rms = float(np.sqrt(np.mean(res_float ** 2)))

    # Integer least squares over the full float covariance (per-component
    # rounding fails here: over a short static window position and
    # ambiguities are near-collinear, see receiver/ambiguity.py), then
    # RTKLIB's ratio validation between the two best lattice points.
    Q = np.linalg.inv(A.T @ A)
    cands, dists = ils_solve(amb, Q[3 * P:, 3 * P:], n_cand=2)
    a_int = cands[0].astype(np.float64)
    ratio = float(dists[1] / max(dists[0], 1e-12))
    amb_frac = float(np.max(np.abs(amb - a_int)))
    fixed = ratio >= ratio_threshold

    x_fix = x_float
    if fixed:
        # Phase-only position back-substitution with the fixed
        # ambiguities; epochs decouple, so solve [K, S-1, 3] jointly by
        # block-diagonal lstsq per position block.
        x_fix = x_float.copy()
        a_kj = a_int[amb_idx]                            # [K, S-1]
        for _ in range(3):
            dd_model, H_geo = model(x_fix)
            r_ph = dd_phase - dd_model - half * a_kj
            step = np.empty_like(x_fix)
            for p in range(P):
                sel = pk == p
                Hp = H_geo[sel].reshape(-1, 3)
                step[p], *_ = np.linalg.lstsq(Hp, r_ph[sel].reshape(-1),
                                              rcond=None)
            x_fix = x_fix + step
            if np.linalg.norm(step) < 1e-5:
                break
        dd_model, _ = model(x_fix)
        res_fix = dd_phase - dd_model - half * a_kj
        phase_rms = float(np.sqrt(np.mean(res_fix ** 2)))

    return RtkSolution(
        baseline=x_fix.mean(axis=0) - base_xyz,
        baseline_float=x_float.mean(axis=0) - base_xyz,
        fixed=fixed, ref_prn=sats[ref],
        prns=np.array([sats[j] for j in oth], np.int32),
        amb_float=amb, amb_frac=amb_frac, ratio=ratio,
        phase_rms=phase_rms, n_epochs=K, n_sats=S, base_xyz=base_xyz,
        baselines=(x_fix - base_xyz) if kinematic else None,
        times=sow if kinematic else None, n_slips=n_slips)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="gps-sdr-rtk",
        description="Double-difference L1 baseline from a RINEX obs pair "
                    "(the software rtkpost of the reference's rtk/ flow)")
    ap.add_argument("rover_obs")
    ap.add_argument("base_obs")
    ap.add_argument("nav")
    ap.add_argument("--base-xyz", metavar="X,Y,Z",
                    help="known base ECEF position (default: single-point)")
    ap.add_argument("--kinematic", action="store_true",
                    help="moving rover: solve one position per epoch "
                         "(RTKLIB kinematic mode; prints the NEU track)")
    args = ap.parse_args(argv)

    from gps_sdr_sim_tpu_torch.models.ephemeris import (IonoUtc,
                                                  read_rinex_nav_all)
    from gps_sdr_sim_tpu_torch.receiver.rinexobs import read_rinex_obs

    rover = read_rinex_obs(args.rover_obs)
    base = read_rinex_obs(args.base_obs)
    eph, _n = read_rinex_nav_all(args.nav, IonoUtc())
    eph_by_prn = {p + 1: eph[0][p] for p in range(32) if eph[0][p].vflg}

    base_xyz = None
    if args.base_xyz:
        base_xyz = np.array([float(v) for v in args.base_xyz.split(",")])
    sol = solve_baseline(rover, base, eph_by_prn, base_xyz=base_xyz,
                         kinematic=args.kinematic)

    neu = ecef2neu(sol.baseline, ltcmat(xyz2llh(sol.base_xyz)))
    print(f"epochs: {sol.n_epochs}   satellites: {sol.n_sats} "
          f"(ref PRN {sol.ref_prn})")
    print(f"float baseline  ECEF [{sol.baseline_float[0]:+11.3f} "
          f"{sol.baseline_float[1]:+11.3f} {sol.baseline_float[2]:+11.3f}] "
          f"m  |b| = {np.linalg.norm(sol.baseline_float):9.3f} m")
    q = "FIX" if sol.fixed else "FLOAT"
    print(f"{q:5s} baseline  ECEF [{sol.baseline[0]:+11.3f} "
          f"{sol.baseline[1]:+11.3f} {sol.baseline[2]:+11.3f}] m  "
          f"NEU [{neu[0]:+9.3f} {neu[1]:+9.3f} {neu[2]:+9.3f}] m  "
          f"|b| = {np.linalg.norm(sol.baseline):9.3f} m")
    print(f"ambiguities (half cycles): ILS ratio {sol.ratio:.1f}, worst "
          f"float-fix gap {sol.amb_frac:.3f}  "
          f"DD phase residual rms {sol.phase_rms * 1e3:.1f} mm")
    if sol.n_slips:
        print(f"cycle slips detected: {sol.n_slips} "
              f"(ambiguities re-initialized at the slip epochs)")
    if sol.baselines is not None:
        # The rtkpost .pos-style track (the reference's gndtrk.png).
        print(f"\n{'SOW':>12s}  {'N[m]':>9s} {'E[m]':>9s} {'U[m]':>9s}")
        lt = ltcmat(xyz2llh(sol.base_xyz))
        for t, bl in zip(sol.times, sol.baselines):
            n, e, u = ecef2neu(bl, lt)
            print(f"{t:12.3f}  {n:+9.3f} {e:+9.3f} {u:+9.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
