"""Single-epoch position fix from tracked channels (the PVT closure).

Pseudoranges are formed the textbook way: each channel's transmit time is
reconstructed from its decoded subframe TOW plus the unwrapped code-phase
chip count since the subframe boundary (chips map to SV transmit time at
exactly 1.023 Mchip/s), the SV clock correction from the *decoded*
ephemeris (receiver/ephdec.py) moves transmit times onto GPS time, and an
iterated least squares with Sagnac correction solves (x, y, z, clock bias).

This closes the full loop the reference validates with hardware + RTKLIB
(rtk/, SURVEY.md §4): IQ samples in, meter-level position out, using only
information recovered from the signal itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from gps_sdr_sim_tpu_torch.constants import (CA_SEQ_LEN, CODE_FREQ, LAMBDA_L1,
                                       OMEGA_EARTH, SPEED_OF_LIGHT)
from gps_sdr_sim_tpu_torch.models.ephemeris import eph_field_arrays
from gps_sdr_sim_tpu_torch.models.orbit import satpos
from gps_sdr_sim_tpu_torch.receiver.ephdec import decode_sets
from gps_sdr_sim_tpu_torch.receiver.navdec import (bit_sync, cn0_estimate,
                                             decode_bits, frame_sync)
from gps_sdr_sim_tpu_torch.receiver.track import TrackResult


@dataclass
class ChannelObs:
    prn: int
    tx_time: float  # SV transmit time (seconds of week, SV clock)
    eph: object     # decoded Ephemeris
    cn0: float = float("nan")        # estimated C/N0 (dB-Hz) for weighting
    doppler_hz: float = float("nan")  # tracked carrier Doppler at epoch m


@dataclass
class PvtSolution:
    xyz: np.ndarray        # ECEF meters
    clock_bias: float      # receiver clock bias (seconds, incl. epoch choice)
    residuals: np.ndarray  # post-fit pseudorange residuals (m)
    n_sats: int
    iterations: int
    t_gps: float = float("nan")  # reception time of the epoch (GPS SOW)


@dataclass
class VelSolution:
    vel: np.ndarray        # ECEF m/s
    clock_drift: float     # receiver clock drift (s/s)
    residuals: np.ndarray  # post-fit range-rate residuals (m/s)
    n_sats: int


def _wrapdiff_arr(d: np.ndarray) -> np.ndarray:
    """Differences wrapped into (-511.5, 511.5] chips."""
    return (d + 511.5) % CA_SEQ_LEN - 511.5


def _bit_edge_chips(prompt: np.ndarray, off: int, cph: np.ndarray) -> float:
    """Chips from bit 0's leading edge to block `off`'s first sample.

    The edge is a code wrap near the block-off boundary: either c0 chips
    BEFORE the block start (the wrap whose phase we are c0 chips into) or
    1023-c0 chips AFTER it. Bit sync is only block-accurate, so when the
    wrap falls mid-block (c0 near 511) the nearest-wrap heuristic can pick
    the wrong side — a 1 ms transmit-time error, ~300 km of pseudorange.
    Disambiguate from the data: at every bit sign transition, the block
    containing the edge has a diluted coherent sum. 'Before' puts the edge
    in block off+20j-1, 'after' in block off+20j; compare |P| there,
    averaged over all transitions.
    """
    c0 = float(cph[off])
    # Clear zones: the wrap is close to the block boundary on one side, so
    # bit sync's block-accuracy already decides (the other candidate would
    # put the edge more than half a block away). The dilution test below
    # would be deciding on noise here (neither block is meaningfully mixed).
    if c0 <= CA_SEQ_LEN / 3:
        return c0
    if c0 >= 2 * CA_SEQ_LEN / 3:
        return c0 - CA_SEQ_LEN
    # Ambiguous middle: the edge is solidly inside block off-1 ('before')
    # or block off ('after'); the mixed block's coherent sum is strongly
    # diluted at every bit transition.
    ip = np.real(prompt)
    n_bits = (len(ip) - off) // 20
    if n_bits >= 2:
        sums = ip[off:off + n_bits * 20].reshape(n_bits, 20).sum(axis=1)
        trans = np.nonzero(np.sign(sums[1:]) != np.sign(sums[:-1]))[0] + 1
        trans = trans[off + 20 * trans < len(ip)]
        if len(trans):
            e = off + 20 * trans
            before = np.abs(ip[e - 1])
            after = np.abs(ip[np.minimum(e, len(ip) - 1)])
            # Edge in the 'after' block => those samples are diluted.
            if float(np.mean(after - before)) < 0:
                return c0 - CA_SEQ_LEN
            return c0
    return c0 if c0 <= CA_SEQ_LEN / 2 else c0 - CA_SEQ_LEN


def transmit_time(off: int, cph: np.ndarray, sbf, m: int,
                  chips_at_off: Optional[float] = None) -> float:
    """SV transmit time (s of week) at the start of tracking block m.

    cph: per-block code phase [n_ms] of this channel (chips, 0..1023);
    off: the channel's bit-sync offset (blocks); sbf: a decoded subframe
    whose bit_index locates its start in the channel's bit stream;
    chips_at_off: bit-edge anchor from _bit_edge_chips (falls back to the
    nearest-wrap heuristic when not given).
    """
    c_off = float(cph[off])
    if chips_at_off is None:
        chips_at_off = c_off if c_off <= CA_SEQ_LEN / 2 else c_off - CA_SEQ_LEN
    # One code period per block. Wraps are counted incrementally: each
    # block's drift is |f_carr|/1540 * 1 ms << half a period, so per-block
    # wrapped differences are exact, and their sum tracks unbounded total
    # drift (a single end-to-start wrapdiff would break once cumulative
    # drift passed ~511 chips, ~2.5 min at 5 kHz Doppler).
    lo, hi = (off, m) if m >= off else (m, off)
    seg = cph[lo:hi + 1].astype(np.float64)
    drift = float(np.sum(_wrapdiff_arr(np.diff(seg))))
    if m < off:
        drift = -drift
    chips = chips_at_off + CA_SEQ_LEN * (m - off) + drift
    chips_since_sbf = chips - sbf.bit_index * 20 * CA_SEQ_LEN
    t_sbf_start = sbf.tow_sec - 6.0  # HOW TOW = start of the NEXT subframe
    return t_sbf_start + chips_since_sbf / CODE_FREQ


def channel_frames(res: TrackResult):
    """Per-channel (bit-sync offset, hard bits, decoded subframes).

    Factored out so callers that also display the decode (the receiver
    CLI's TOW/week table) share one decode with the PVT observables.
    """
    out = []
    for c in range(res.prompt.shape[1]):
        p = res.prompt[:, c]
        off = bit_sync(p)
        bits = decode_bits(p, off)
        out.append((off, bits, frame_sync(bits)))
    return out


@dataclass
class ChannelPrep:
    """Per-channel epoch-invariant decode products (reused across the
    per-epoch solves of a --pvt-track run instead of being recomputed
    at every track epoch)."""
    off: int
    sbfs: list
    sets: list
    anchor: float  # _bit_edge_chips at off
    cn0: float


def prepare_observables(res: TrackResult, frames=None):
    """One-time decode shared by every measurement epoch.

    Returns (preps [C], ionoutc): ionoutc is decoded from the first
    subframe 4 page 18 seen on any channel (None when absent, e.g. short
    captures or iono-disabled scenarios).
    """
    from gps_sdr_sim_tpu_torch.receiver.ephdec import decode_ionoutc

    if frames is None:
        frames = channel_frames(res)
    preps = []
    ionoutc = None
    for c in range(res.prompt.shape[1]):
        off, _bits, sbfs = frames[c]
        sets = decode_sets(sbfs)
        if ionoutc is None:
            for s in sbfs:
                if s.sbf_id == 4:
                    ionoutc = decode_ionoutc(s)  # None for non-18 pages
                    if ionoutc is not None:
                        break
        anchor = (_bit_edge_chips(res.prompt[:, c], off,
                                  res.code_phase[:, c]) if sets else 0.0)
        preps.append(ChannelPrep(off=off, sbfs=sbfs, sets=sets,
                                 anchor=anchor,
                                 cn0=cn0_estimate(res.prompt[:, c])))
    return preps, ionoutc


def observables(res: TrackResult, m: Optional[int] = None, frames=None,
                prep=None) -> "tuple[List[ChannelObs], object]":
    """Decode every channel and form its transmit-time observable at
    tracking block m (default: the last fully-tracked block).

    Pass `prep` (from prepare_observables) when solving many epochs of
    the same capture — the decode/C/N0/bit-edge work is epoch-invariant.
    """
    n_ms = res.prompt.shape[0]
    if m is None:
        m = n_ms - 2
    if prep is None:
        prep = prepare_observables(res, frames)
    preps, ionoutc = prep
    out = []
    for c, prn in enumerate(res.prns):
        p = preps[c]
        if not p.sets:
            continue
        # The data set in force at the measurement epoch: the latest set
        # fully received before block m (a capture crossing a 2 h cutover
        # decodes both; the pre-cutover set anchors earlier epochs).
        bit_m = (m - p.off) // 20
        eph = p.sets[0].eph
        for es in p.sets:
            if es.last_bit <= bit_m:
                eph = es.eph
        if eph.svhlth:
            continue
        tx = transmit_time(p.off, res.code_phase[:, c], p.sbfs[0], m,
                           chips_at_off=p.anchor)
        # Doppler observable: mean of the PLL frequency estimate over the
        # 0.1 s generator epoch containing block m (the signal's carrier
        # frequency is constant per epoch — gpssim.c:2156-2177 — so the
        # aligned window averages one constant, mixing no two epochs).
        e0 = (m // 100) * 100
        dop = float(np.mean(res.doppler[e0:min(e0 + 100, n_ms), c]))
        out.append(ChannelObs(prn=int(prn), tx_time=tx, eph=eph,
                              cn0=p.cn0, doppler_hz=dop))
    return out, ionoutc


def _iono_correction(ionoutc, x, t_rx, pos):
    """Klobuchar delay (m) per satellite for a receiver at ECEF x."""
    from gps_sdr_sim_tpu_torch.models.atmosphere import ionospheric_delay
    from gps_sdr_sim_tpu_torch.utils.coord import (ecef2neu, ltcmat, neu2azel,
                                             xyz2llh)

    llh = xyz2llh(x)
    azel = neu2azel(ecef2neu(pos - x, ltcmat(llh)))
    return ionospheric_delay(ionoutc, t_rx, llh, azel)


def solve(obs: Sequence[ChannelObs], ionoutc=None,
          max_iter: int = 10, cn0_weighted: bool = False) -> PvtSolution:
    """Iterated least squares for (x, y, z, receiver clock bias).

    With `ionoutc` (decoded from subframe 4 page 18), the Klobuchar model
    is evaluated at the converged position and the solve repeats on the
    corrected pseudoranges — same two-pass shape real receivers use.
    With `cn0_weighted`, each channel's equation is weighted by its
    estimated linear C/N0 (pseudorange noise variance scales as 1/(C/N0)),
    de-emphasizing weak low-elevation channels like production receivers.
    """
    if len(obs) < 4:
        raise ValueError(f"need >=4 usable channels, got {len(obs)}")

    w = np.ones(len(obs))
    if cn0_weighted:
        cn0 = np.array([o.cn0 for o in obs])
        lin = np.where(np.isfinite(cn0), 10.0 ** (cn0 / 10.0), 0.0)
        if lin.max() > 0:
            w = np.sqrt(lin / lin.max())  # row scaling = sqrt(weight)
            w = np.maximum(w, 1e-3)

    eph = eph_field_arrays([o.eph for o in obs])
    tx_sv = np.array([o.tx_time for o in obs])

    # SV clock correction (af0/af1/af2 + relativistic - TGD) moves transmit
    # instants onto GPS time; satpos wants GPS seconds.
    _, _, clk = satpos(eph, tx_sv)
    dtsv = clk[..., 0]
    tx_gps = tx_sv - dtsv
    pos, _, _ = satpos(eph, tx_gps)

    # Receiver epoch: any common instant after all transmissions; its exact
    # value lands in the clock-bias unknown.
    t_rx = tx_gps.max() + 0.08
    prange = SPEED_OF_LIGHT * (t_rx - tx_sv)

    def run_ls(prange, x, b):
        for it in range(max_iter):
            tau = np.linalg.norm(pos - x, axis=1) / SPEED_OF_LIGHT
            # Sagnac: rotate each SV into the ECEF frame of reception time.
            ang = OMEGA_EARTH * tau
            ca, sa = np.cos(ang), np.sin(ang)
            px = ca * pos[:, 0] + sa * pos[:, 1]
            py = -sa * pos[:, 0] + ca * pos[:, 1]
            p_rot = np.stack([px, py, pos[:, 2]], axis=1)

            los = p_rot - x
            rho = np.linalg.norm(los, axis=1)
            # Modeled pseudorange: geometric range + c*(b - dtsv).
            pred = rho + b - SPEED_OF_LIGHT * dtsv
            r = prange - pred
            H = np.concatenate([-los / rho[:, None],
                                np.ones((len(obs), 1))], axis=1)
            dx, *_ = np.linalg.lstsq(H * w[:, None], r * w, rcond=None)
            x = x + dx[:3]
            b = b + dx[3]
            if np.linalg.norm(dx[:3]) < 1e-4:
                break
        return x, b, r - H @ dx, it + 1

    x, b, res, iters = run_ls(prange, np.zeros(3), 0.0)
    if ionoutc is not None and ionoutc.vflg:
        iono = _iono_correction(ionoutc, x, t_rx % 604800.0, pos)
        x, b, res, it2 = run_ls(prange - iono, x, b)
        iters += it2

    return PvtSolution(xyz=x, clock_bias=b / SPEED_OF_LIGHT,
                       residuals=res, n_sats=len(obs), iterations=iters,
                       t_gps=t_rx - b / SPEED_OF_LIGHT)


def solve_velocity(obs: Sequence[ChannelObs],
                   sol: PvtSolution) -> VelSolution:
    """Receiver velocity + clock drift from the tracked carrier Doppler.

    The signal's Doppler encodes the generator's pseudorange rate
    (gpssim.c:1324-1327: f_carr = -dRho/dt / lambda, where the pseudorange
    carries the -c*dtsv SV-clock term, gpssim.c:1288), so the measurement
    model at the converged position fix is

        -lambda * f_d = (v_sat - v_rx) . e  -  c*dtsv_dot  +  c*bdot

    which is LINEAR in the unknowns (v_rx, c*bdot) — one least-squares
    solve, no iteration. Sub-cm/s effects (Sagnac rate, iono rate) are
    ignored; the generator's 0.1 s backward-difference Doppler skews the
    observable by ~a*0.05 s for an accelerating receiver, which bounds the
    accuracy of this solve at a few cm/s on the circle trajectory.
    """
    use = [o for o in obs if np.isfinite(o.doppler_hz)]
    if len(use) < 4:
        raise ValueError(f"need >=4 Doppler observables, got {len(use)}")
    lam = LAMBDA_L1

    eph = eph_field_arrays([o.eph for o in use])
    tx_sv = np.array([o.tx_time for o in use])
    _, _, clk = satpos(eph, tx_sv)
    pos, vel, clk = satpos(eph, tx_sv - clk[..., 0])

    los = pos - sol.xyz
    e = los / np.linalg.norm(los, axis=1)[:, None]
    f_d = np.array([o.doppler_hz for o in use])
    # y = measured range rate minus the satellite's own contributions.
    y = (-lam * f_d - np.sum(vel * e, axis=1)
         + SPEED_OF_LIGHT * clk[..., 1])
    H = np.concatenate([-e, np.ones((len(use), 1))], axis=1)
    d, *_ = np.linalg.lstsq(H, y, rcond=None)
    return VelSolution(vel=d[:3], clock_drift=d[3] / SPEED_OF_LIGHT,
                       residuals=y - H @ d, n_sats=len(use))
