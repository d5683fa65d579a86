"""Scenario engine: turns a simulator config into device-ready epoch plans.

This is the host-side replication of the reference main() control flow
(gpssim.c:1672-2369): start-time resolution and -T TOC/TOE overwrite
(gpssim.c:1978-2035), ephemeris-set selection (gpssim.c:2042-2067), channel
allocation (allocateChannel, gpssim.c:1572-1648), the per-epoch observable
updates (computeRange + computeCodePhase, gpssim.c:2156-2188), and the
30-second navigation-message / re-allocation cadence (gpssim.c:2293-2345).

TPU-native reformulation: instead of carrying a per-sample NCO, the engine
emits, per epoch and channel, the closed-form phase-ramp parameters
(f_carr, f_code, code_phase0, carr_phase0, nav-bit counter M0, gain) plus
per-segment C/A chip and nav-bit tables. Carrier phase continuity across
epochs (the only cross-epoch recurrence in the reference, gpssim.c:2244-2250)
is propagated analytically in float64 on the host. Every epoch is then an
independent, embarrassingly parallel unit of device work, which is what
makes time-block sharding over a TPU mesh possible.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from gps_sdr_sim_tpu_torch.constants import (
    CA_SEQ_LEN,
    CARR_TO_CODE,
    CODE_FREQ,
    EPHEM_ARRAY_SIZE,
    LAMBDA_L1,
    MAX_CHAN,
    MAX_SAT,
    N_DWRD,
    R2D,
    SECONDS_IN_HOUR,
    SPEED_OF_LIGHT,
    USER_MOTION_SIZE,
)
from gps_sdr_sim_tpu_torch.models.antenna import signal_gain
from gps_sdr_sim_tpu_torch.models.cacode import codegen
from gps_sdr_sim_tpu_torch.models.ephemeris import (
    IonoUtc,
    eph_field_arrays,
    read_rinex_nav_all,
)
from gps_sdr_sim_tpu_torch.models.navmsg import dwrd_to_bits, eph2sbf, generate_nav_msg
from gps_sdr_sim_tpu_torch.models.observables import compute_range, sat_visibility
from gps_sdr_sim_tpu_torch.models.trajectory import read_nmea_gga, read_user_motion
from gps_sdr_sim_tpu_torch.utils.coord import llh2xyz, ltcmat, xyz2llh
from gps_sdr_sim_tpu_torch.utils.cstd import c_round
from gps_sdr_sim_tpu_torch.utils.gpstime import (
    DateTime,
    GpsTime,
    date2gps,
    gps2date,
    inc_gps_time,
    sub_gps_time,
)

_WEEK_MS = 604800000


class ScenarioError(ValueError):
    """Raised for invalid configurations (the CLI maps these to exit(1))."""


@dataclass
class ScenarioConfig:
    nav_file: str
    out_file: str = "gpssim.bin"
    samp_freq: float = 2.6e6
    data_format: int = 16  # 1 / 8 / 16
    static_xyz: Optional[np.ndarray] = None  # ECEF, set by -c or -l
    motion_file: Optional[str] = None  # -u
    nmea_file: Optional[str] = None  # -g
    duration: Optional[float] = None  # -d
    t0: Optional[DateTime] = None  # -t / -T
    timeoverwrite: bool = False  # -T
    iono_enable: bool = True  # -i disables
    verbose: bool = False  # -v
    max_motion_points: int = USER_MOTION_SIZE
    static_max_duration: float = 86400.0
    # "float" = the reference's default f64 carrier NCO (FLOAT_CARR_PHASE
    # defined, gpssim.h:4); "fixed" = its 32-bit fixed-point NCO compile
    # variant, here a runtime mode (--carrier-phase fixed).
    carrier_phase_mode: str = "float"


@dataclass
class Segment:
    """A run of epochs with a fixed channel allocation and nav-bit tables.

    Epoch-indexed arrays have shape [n_epochs, MAX_CHAN]; epoch e of this
    segment synthesizes output block (first_epoch - 1 + e).
    """

    first_epoch: int  # iumd of the first synthesized epoch (1-based)
    n_epochs: int
    active: np.ndarray  # [C] bool
    prn: np.ndarray  # [C] int32 (0 = free)
    ca: np.ndarray  # [C, 1023] int8, chips in {-1, +1}
    bits: np.ndarray  # [C, 1800] int8, nav bits in {-1, +1}
    f_carr: np.ndarray  # [E, C] f64 carrier Doppler (Hz)
    f_code: np.ndarray  # [E, C] f64 code rate (chips/s)
    code_phase0: np.ndarray  # [E, C] f64 chips in [0, 1023)
    carr_phase0: np.ndarray  # [E, C] f64 cycles in [0, 1)
    m0: np.ndarray  # [E, C] int32 nav ms counter at epoch start
    gain: np.ndarray  # [E, C] int32 amplitude (2^7-scaled)
    # True = carr_phase0 values lie on the 2^-25-cycle grid of the
    # reference's 32-bit fixed-point carrier NCO (FLOAT_CARR_PHASE
    # undefined, gpssim.c:2175-2177,2251-2252) and the planner must
    # quantize the carrier step the same way.
    carr_fixed: bool = False


@dataclass
class _Channel:
    prn: int = 0
    ca: Optional[np.ndarray] = None  # {0,1} chips
    sbf: Optional[np.ndarray] = None
    dwrd: Optional[np.ndarray] = None
    g0: GpsTime = field(default_factory=GpsTime)
    carr_phase: float = 0.0
    carr_phase25: int = 0  # fixed mode: phase mod 2^25 (unit 2^-25 cycles)
    rho0_range: float = 0.0
    rho0_gsec: float = 0.0
    rho0_week: int = 0
    rho0_d: float = 0.0
    rho0_iono: float = 0.0
    azel: tuple = (0.0, 0.0)


@dataclass
class Scenario:
    config: ScenarioConfig
    g0: GpsTime
    t0: DateTime
    numd: int
    iq_buff_size: int  # samples per 0.1 s epoch
    samp_freq: float
    delt: float
    segments: List[Segment]
    channel_tables: List[tuple]  # (iumd, [(prn, az_deg, el_deg, d, iono)])
    ionoutc: IonoUtc
    ionoutc_file: IonoUtc  # as parsed, before any -T wnt/tot overwrite

    @property
    def n_output_epochs(self) -> int:
        return max(self.numd - 1, 0)

    @property
    def total_samples(self) -> int:
        return self.n_output_epochs * self.iq_buff_size


def _epoch_times(g0: GpsTime, numd: int):
    """Absolute GPS time of every motion epoch, in closed form.

    The reference advances grx by inc_gps_time(grx, 0.1) per epoch, which
    snaps to the nearest millisecond each step (gpssim.c:796); since g0 is
    on an integer millisecond this equals exact 100 ms integer steps.
    """
    g0_ms = g0.week * _WEEK_MS + int(round(g0.sec * 1000.0))
    total = g0_ms + 100 * np.arange(numd, dtype=np.int64)
    week = (total // _WEEK_MS).astype(np.int64)
    sec = (total % _WEEK_MS).astype(np.float64) / 1000.0
    return week, sec


def _resolve_start_time(cfg: ScenarioConfig, eph, neph, ionoutc: IonoUtc):
    """Start-time resolution and -T overwrite (gpssim.c:1950-2035)."""
    gmin = tmin = None
    for sv in range(MAX_SAT):
        if eph[0][sv].vflg == 1:
            gmin = eph[0][sv].toc.copy()
            tmin = eph[0][sv].t.copy()
            break
    gmax = GpsTime(0, 0.0)
    tmax = DateTime()
    for sv in range(MAX_SAT):
        if eph[neph - 1][sv].vflg == 1:
            gmax = eph[neph - 1][sv].toc.copy()
            tmax = eph[neph - 1][sv].t.copy()
            break
    if gmin is None:
        raise ScenarioError("No ephemeris available.")

    if cfg.t0 is not None:
        g0 = date2gps(cfg.t0)
        t0 = cfg.t0.copy()
        if cfg.timeoverwrite:
            gtmp = GpsTime(g0.week, float((int(g0.sec)) // 7200 * 7200))
            dsec = sub_gps_time(gtmp, gmin)
            # Overwrite the UTC reference week/time (gpssim.c:1992-1993)
            ionoutc.wnt = gtmp.week
            ionoutc.tot = int(gtmp.sec)
            for sv in range(MAX_SAT):
                for i in range(neph):
                    e = eph[i][sv]
                    if e.vflg == 1:
                        e.toc = inc_gps_time(e.toc, dsec)
                        e.t = gps2date(e.toc)
                        e.toe = inc_gps_time(e.toe, dsec)
        else:
            if sub_gps_time(g0, gmin) < 0.0 or sub_gps_time(gmax, g0) < 0.0:
                raise ScenarioError(
                    "Invalid start time.\n"
                    f"tmin = {tmin.y:4d}/{tmin.m:02d}/{tmin.d:02d},"
                    f"{tmin.hh:02d}:{tmin.mm:02d}:{tmin.sec:02.0f} "
                    f"({gmin.week}:{gmin.sec:.0f})\n"
                    f"tmax = {tmax.y:4d}/{tmax.m:02d}/{tmax.d:02d},"
                    f"{tmax.hh:02d}:{tmax.mm:02d}:{tmax.sec:02.0f} "
                    f"({gmax.week}:{gmax.sec:.0f})")
    else:
        g0 = gmin.copy()
        t0 = tmin.copy()

    return g0, t0


def _select_ephem_set(eph, neph, g0: GpsTime) -> int:
    """Current ephemeris-set selection, +-1 h around g0 (gpssim.c:2042-2067)."""
    for i in range(neph):
        for sv in range(MAX_SAT):
            if eph[i][sv].vflg == 1:
                dt = sub_gps_time(g0, eph[i][sv].toc)
                if -SECONDS_IN_HOUR <= dt < SECONDS_IN_HOUR:
                    return i
    raise ScenarioError("No current set of ephemerides has been found.")


def build_scenario(cfg: ScenarioConfig) -> Scenario:
    """Build the full host-side plan for a simulation run.

    Materializes every segment up front (fine up to a few hours; ~640 B
    per epoch-channel of plan state). For day-scale runs use
    build_scenario_streaming, which plans segments lazily in step with
    synthesis so host memory stays at one 30 s segment.
    """
    scn, engine = _prepare_scenario(cfg)
    scn.segments, scn.channel_tables = engine.run()
    return scn


def build_scenario_streaming(cfg: ScenarioConfig):
    """Lazy variant of build_scenario for long-context (day-scale) runs.

    Returns (scenario, engine): scenario.segments is EMPTY; iterate
    engine.iter_run() to receive Segments one 30 s allocation span at a
    time (the reference's own cadence, gpssim.c:2293-2345). Planning
    happens on demand, so peak memory is one segment's state instead of
    the whole run's. engine.tables accumulates the stderr channel-table
    snapshots as planning advances.
    """
    return _prepare_scenario(cfg)


def _prepare_scenario(cfg: ScenarioConfig):
    """Shared setup: parse inputs, resolve time, build the epoch engine."""
    if cfg.carrier_phase_mode not in ("float", "fixed"):
        raise ScenarioError(
            f"Invalid carrier phase mode: {cfg.carrier_phase_mode}")
    # ---- Receiver trajectory (gpssim.c:1887-1917) ----
    # Static mode WINS when both a static location and a motion file are
    # given, like the reference (staticLocationMode gates the motion-file
    # read entirely, gpssim.c:1887).
    static_mode = cfg.static_xyz is not None
    if not static_mode and (cfg.motion_file or cfg.nmea_file):
        try:
            if cfg.nmea_file:
                xyz = read_nmea_gga(cfg.nmea_file, cfg.max_motion_points)
            else:
                xyz = read_user_motion(cfg.motion_file,
                                       cfg.max_motion_points)
        except OSError:
            raise ScenarioError(
                "Failed to open user motion / NMEA GGA file.")
        if xyz.shape[0] == 0:
            raise ScenarioError("Failed to read user motion / NMEA GGA data.")
    elif cfg.static_xyz is not None:
        xyz = np.asarray(cfg.static_xyz, dtype=np.float64).reshape(1, 3)
    else:
        # Default static location: Tokyo (gpssim.c:1860-1867)
        llh = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
        xyz = llh2xyz(llh).reshape(1, 3)
        static_mode = True

    # ---- Duration -> epoch count (gpssim.c:1869-1874) ----
    duration = cfg.duration
    if duration is None:
        duration = float(cfg.max_motion_points) / 10.0
    max_dur = (cfg.static_max_duration if static_mode
               else float(cfg.max_motion_points) / 10.0)
    if duration < 0.0 or duration > max_dur:
        raise ScenarioError("Invalid duration.")
    iduration = int(duration * 10.0 + 0.5)

    if not static_mode:
        numd = min(xyz.shape[0], iduration)
    else:
        numd = iduration

    # ---- Sample rate / buffer (gpssim.c:1876-1881) ----
    samp_freq = math.floor(cfg.samp_freq / 10.0)
    iq_buff_size = int(samp_freq)
    samp_freq *= 10.0
    delt = 1.0 / samp_freq

    # ---- Ephemerides ----
    ionoutc = IonoUtc(enable=cfg.iono_enable)
    eph, neph = read_rinex_nav_all(cfg.nav_file, ionoutc)
    if neph == 0:
        raise ScenarioError("No ephemeris available.")
    if neph == -1:
        raise ScenarioError("ephemeris file not found.")

    # Snapshot for the -v iono/UTC dump: the reference prints it straight
    # after the RINEX parse, BEFORE -T overwrites wnt/tot
    # (gpssim.c:1938-1948 vs :1990-1993).
    ionoutc_file = copy.copy(ionoutc)

    g0, t0 = _resolve_start_time(cfg, eph, neph, ionoutc)

    # Epoch times and receiver positions. max(numd, 1): a zero-duration run
    # still allocates channels from the first position and prints the
    # channel table, writing no samples, like the reference.
    grx_week, grx_sec = _epoch_times(g0, max(numd, 1))
    if static_mode:
        xyz_ep = np.broadcast_to(xyz[0], (max(numd, 1), 3))
    else:
        xyz_ep = xyz[:max(numd, 1)]

    engine = _Engine(cfg, eph, neph, ionoutc, g0, grx_week, grx_sec,
                     xyz_ep, numd, iq_buff_size, delt)
    scn = Scenario(
        config=cfg, g0=g0, t0=t0, numd=numd, iq_buff_size=iq_buff_size,
        samp_freq=samp_freq, delt=delt, segments=[],
        channel_tables=engine.tables, ionoutc=ionoutc,
        ionoutc_file=ionoutc_file,
    )
    return scn, engine


class _Engine:
    """Replays the reference epoch loop, recording device-ready state."""

    def __init__(self, cfg, eph, neph, ionoutc, g0, grx_week, grx_sec,
                 xyz_ep, numd, iq_buff_size, delt):
        self.cfg = cfg
        self.eph = eph
        self.neph = neph
        self.ionoutc = ionoutc
        self.g0 = g0
        self.grx_week = grx_week
        self.grx_sec = grx_sec
        self.xyz_ep = xyz_ep
        self.numd = numd
        self.N = iq_buff_size
        self.delt = delt

        self.fixed_carr = cfg.carrier_phase_mode == "fixed"
        self.ieph = _select_ephem_set(eph, neph, g0)
        self.chan = [_Channel() for _ in range(MAX_CHAN)]
        self.allocated_sat = [-1] * MAX_SAT
        self._fields_cache = {}
        self.tables = []  # stderr channel-table snapshots, filled by run

    # -- helpers ---------------------------------------------------------

    def _fields(self, ieph):
        if ieph not in self._fields_cache:
            self._fields_cache[ieph] = eph_field_arrays(self.eph[ieph])
        return self._fields_cache[ieph]

    def _gps(self, e: int) -> GpsTime:
        return GpsTime(int(self.grx_week[e]), float(self.grx_sec[e]))

    def _allocate(self, e: int):
        """allocateChannel at epoch e (gpssim.c:1572-1648)."""
        grx = self._gps(e)
        fields = self._fields(self.ieph)
        xyz = self.xyz_ep[e]
        llh = xyz2llh(xyz)
        tmat = ltcmat(llh)
        vis, azel = sat_visibility(fields, grx.sec, xyz, 0.0)

        for sv in range(MAX_SAT):
            if vis[sv]:
                if self.allocated_sat[sv] == -1:
                    # Find a free channel slot (first fit).
                    slot = next((i for i in range(MAX_CHAN)
                                 if self.chan[i].prn == 0), None)
                    if slot is not None:
                        ch = self.chan[slot]
                        ch.prn = sv + 1
                        ch.azel = (float(azel[sv, 0]), float(azel[sv, 1]))
                        ch.ca = codegen(ch.prn)
                        ch.sbf = eph2sbf(self.eph[self.ieph][sv], self.ionoutc)
                        ch.dwrd = np.zeros(N_DWRD, dtype=np.uint64)
                        ch.g0 = generate_nav_msg(grx, ch.sbf, ch.dwrd, True)

                        one = {k: v[sv] for k, v in fields.items()}
                        rho = compute_range(one, self.ionoutc, grx.sec, xyz,
                                            llh=llh, tmat=tmat)
                        ch.rho0_range = float(rho["range"])
                        ch.rho0_gsec = grx.sec
                        ch.rho0_week = grx.week
                        ch.rho0_d = float(rho["d"])
                        ch.rho0_iono = float(rho["iono_delay"])
                        r_xyz = float(rho["range"])

                        rho_ref = compute_range(one, self.ionoutc, grx.sec,
                                                np.zeros(3))
                        r_ref = float(rho_ref["range"])

                        phase_ini = (2.0 * r_ref - r_xyz) / LAMBDA_L1
                        ch.carr_phase = phase_ini - math.floor(phase_ini)
                        # Fixed mode: (unsigned int)(512.0*65536.0*frac)
                        # (gpssim.c:1624-1625), i.e. truncation to the
                        # 2^-25-cycle grid.
                        ch.carr_phase25 = int(ch.carr_phase * 33554432.0)
                        self.allocated_sat[sv] = slot
            elif self.allocated_sat[sv] >= 0:
                self.chan[self.allocated_sat[sv]].prn = 0
                self.allocated_sat[sv] = -1

    def _table_snapshot(self, iumd):
        rows = []
        for ch in self.chan:
            if ch.prn > 0:
                rows.append((ch.prn, ch.azel[0] * R2D, ch.azel[1] * R2D,
                             ch.rho0_d, ch.rho0_iono))
        return (iumd, rows)

    # -- main ------------------------------------------------------------

    def run(self):
        return list(self.iter_run()), self.tables

    def iter_run(self):
        """Lazily yield Segments in output order (single pass).

        Channel state advances sequentially (the reference's epoch loop);
        tables snapshots accumulate on self.tables as planning reaches
        each 30 s boundary. Memory stays at one segment's plan state —
        the long-context mode (SURVEY.md §2.4/§5).
        """
        self.tables.clear()  # in place: Scenario.channel_tables aliases it

        # Initial allocation at grx = g0 (gpssim.c:2126-2136).
        self._allocate(0)
        self.tables.append(self._table_snapshot(0))

        if self.numd <= 1:
            return

        # 30 s boundaries: epochs e in [1, numd-1] where the absolute GPS
        # time is a multiple of 30 s (gpssim.c:2294-2296).
        igrx = ((self.grx_sec * 10.0 + 0.5).astype(np.int64))
        is_boundary = (igrx % 300) == 0

        seg_start = 1
        while seg_start <= self.numd - 1:
            # Segment runs until the next boundary (inclusive) or the end.
            end = seg_start
            while end < self.numd - 1 and not is_boundary[end]:
                end += 1
            yield self._run_segment(seg_start, end)

            if is_boundary[end]:
                self._boundary(end)
                if self.cfg.verbose:
                    self.tables.append(self._table_snapshot(end))
            seg_start = end + 1

    def _run_segment(self, start: int, end: int) -> Segment:
        """Per-epoch state for epochs [start, end], vectorized over BOTH
        the epoch and the channel axis.

        One batched compute_range call covers every active channel (fields
        shaped [A, 1] broadcasting against g_sec [E]); all per-element f64
        arithmetic is identical to the per-channel formulation, so the
        output is bit-exact regardless of how many channels are batched.
        """
        E = end - start + 1
        C = MAX_CHAN
        fields = self._fields(self.ieph)

        active = np.array([ch.prn > 0 for ch in self.chan])
        prn = np.array([ch.prn for ch in self.chan], dtype=np.int32)

        f_carr = np.zeros((E, C))
        f_code = np.full((E, C), CODE_FREQ)
        code_phase0 = np.zeros((E, C))
        carr_phase0 = np.zeros((E, C))
        m0 = np.zeros((E, C), dtype=np.int32)
        gain = np.zeros((E, C), dtype=np.int32)
        ca = np.ones((C, CA_SEQ_LEN), dtype=np.int8)
        bits = np.ones((C, 1800), dtype=np.int8)

        act = [ci for ci in range(C) if self.chan[ci].prn > 0]
        if not act:
            return Segment(
                first_epoch=start, n_epochs=E, active=active, prn=prn,
                ca=ca, bits=bits, f_carr=f_carr, f_code=f_code,
                code_phase0=code_phase0, carr_phase0=carr_phase0, m0=m0,
                gain=gain, carr_fixed=self.fixed_carr)
        chans = [self.chan[ci] for ci in act]
        svs = np.array([ch.prn - 1 for ch in chans])
        A = len(act)

        g_sec = self.grx_sec[start:end + 1]  # [E]
        xyz_seg = self.xyz_ep[start:end + 1]
        llh_seg = xyz2llh(xyz_seg)       # once per segment, not per channel
        tmat_seg = ltcmat(llh_seg)

        many = {k: v[svs][:, None] for k, v in fields.items()}  # [A, 1]
        rho = compute_range(many, self.ionoutc, g_sec, xyz_seg,
                            llh=llh_seg, tmat=tmat_seg)  # values [A, E]

        # rho0 chain: previous epoch's range, then this segment's.
        rho0_range = np.array([ch.rho0_range for ch in chans])
        rr = np.concatenate([rho0_range[:, None], rho["range"]], axis=1)
        rate = (rr[:, 1:] - rr[:, :-1]) / 0.1
        fc = -rate / LAMBDA_L1  # [A, E]
        f_carr[:, act] = fc.T
        f_code[:, act] = (CODE_FREQ + fc * CARR_TO_CODE).T

        # ms counter from the *previous* epoch's observation time
        # (computeCodePhase, gpssim.c:1331-1342).
        prev_week = np.concatenate(
            [np.array([ch.rho0_week for ch in chans], np.float64)[:, None],
             np.broadcast_to(self.grx_week[start:end], (A, E - 1))], axis=1)
        prev_sec = np.concatenate(
            [np.array([ch.rho0_gsec for ch in chans])[:, None],
             np.broadcast_to(self.grx_sec[start:end], (A, E - 1))], axis=1)
        g0_sec = np.array([ch.g0.sec for ch in chans])[:, None]
        g0_week = np.array([ch.g0.week for ch in chans],
                           np.float64)[:, None]
        trel = (prev_sec - g0_sec) + (prev_week - g0_week) * 604800.0
        ms = ((trel + 6.0) - rr[:, :-1] / SPEED_OF_LIGHT) * 1000.0
        ims = ms.astype(np.int64)  # C (int) truncation
        code_phase0[:, act] = ((ms - ims) * CA_SEQ_LEN).T
        m0[:, act] = ims.T

        # Carrier phase: analytic continuation of the reference's
        # per-sample accumulate-and-wrap. float mode: the f64 NCO
        # (gpssim.c:2244-2250). fixed mode: the 32-bit NCO stepping by
        # round(2^25 * f_carr * delt) counts (gpssim.c:2175-2177,
        # :2252) — the per-epoch advance N*step is EXACT integer
        # arithmetic, and only the phase mod 2^25 reaches the 9-bit
        # table index, so tracking mod 2^25 reproduces the wrapping
        # 32-bit add bit-for-bit.
        if self.fixed_carr:
            steps25 = c_round(fc * self.delt * 33554432.0).astype(np.int64)
            ph250 = np.array([ch.carr_phase25 for ch in chans])[:, None]
            cum = ph250 + np.concatenate(
                [np.zeros((A, 1), np.int64),
                 np.cumsum(self.N * steps25, axis=1)], axis=1)
            ph25 = cum % (1 << 25)
            carr_phase0[:, act] = (ph25[:, :-1] / 33554432.0).T
            for i, ch in enumerate(chans):
                ch.carr_phase25 = int(ph25[i, -1])
        else:
            inc = self.N * fc * self.delt
            ph0 = np.array([ch.carr_phase for ch in chans])[:, None]
            phases = ph0 + np.concatenate(
                [np.zeros((A, 1)), np.cumsum(inc, axis=1)], axis=1)
            carr_phase0[:, act] = \
                (phases[:, :-1] - np.floor(phases[:, :-1])).T
            for i, ch in enumerate(chans):
                ch.carr_phase = float(phases[i, -1]
                                      - math.floor(phases[i, -1]))

        # Amplitude model uses the *current* epoch's range (gpssim.c:2179).
        gain[:, act] = signal_gain(rho["d"], rho["azel"][..., 1]).T

        for i, ci in enumerate(act):
            ch = chans[i]
            ca[ci] = (ch.ca * 2 - 1).astype(np.int8)
            bits[ci] = dwrd_to_bits(ch.dwrd)

            # Advance channel state to the segment end.
            ch.rho0_range = float(rho["range"][i, -1])
            ch.rho0_gsec = float(g_sec[-1])
            ch.rho0_week = int(self.grx_week[end])
            ch.rho0_d = float(rho["d"][i, -1])
            ch.rho0_iono = float(rho["iono_delay"][i, -1])
            ch.azel = (float(rho["azel"][i, -1, 0]),
                       float(rho["azel"][i, -1, 1]))

        return Segment(
            first_epoch=start, n_epochs=E, active=active, prn=prn, ca=ca,
            bits=bits, f_carr=f_carr, f_code=f_code, code_phase0=code_phase0,
            carr_phase0=carr_phase0, m0=m0, gain=gain,
            carr_fixed=self.fixed_carr,
        )

    def _boundary(self, e: int):
        """30 s boundary processing after epoch e (gpssim.c:2296-2345)."""
        grx = self._gps(e)

        # 1. Update navigation message (uses the *current* sbf).
        for ch in self.chan:
            if ch.prn > 0:
                ch.g0 = generate_nav_msg(grx, ch.sbf, ch.dwrd, False)

        # 2. Ephemeris-set advance (gpssim.c:2307-2326): first valid SV in
        #    the next set decides; on advance, refresh allocated subframes.
        if self.ieph + 1 < EPHEM_ARRAY_SIZE:
            for sv in range(MAX_SAT):
                if self.eph[self.ieph + 1][sv].vflg == 1:
                    dt = sub_gps_time(self.eph[self.ieph + 1][sv].toc, grx)
                    if dt < SECONDS_IN_HOUR:
                        self.ieph += 1
                        for ch in self.chan:
                            if ch.prn != 0:
                                ch.sbf = eph2sbf(
                                    self.eph[self.ieph][ch.prn - 1],
                                    self.ionoutc)
                    break

        # 3. Re-allocate channels.
        self._allocate(e)
