"""Broadcast ephemeris model and RINEX 2 navigation-file parser.

Parity targets: ephem_t/ionoutc_t (gpssim.h:101-147) and readRinexNavAll
(gpssim.c:818-1168), including:
 - fixed-column field extraction with C atof/atoi semantics,
 - 'D' -> 'E' exponent designator replacement (gpssim.c:763-777),
 - the seconds field of the epoch being truncated to 2 chars (gpssim.c:970-972),
 - splitting into a new ephemeris set when toc jumps by > 1 hour
   (gpssim.c:980-989), at most EPHEM_ARRAY_SIZE sets,
 - iono/UTC header flags: all four lines must be present (and DELTA-UTC's
   tot % 4096 == 0) for ionoutc.vflg (gpssim.c:918-933),
 - the svhlth MSB fix (gpssim.c:1135-1136),
 - derived working variables A, n, sq1e2, omgkdot (gpssim.c:1155-1159).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from gps_sdr_sim_tpu_torch.constants import (
    EPHEM_ARRAY_SIZE,
    GM_EARTH,
    MAX_SAT,
    OMEGA_EARTH,
    SECONDS_IN_HOUR,
)
from gps_sdr_sim_tpu_torch.utils.cstd import c_atof, c_atoi
from gps_sdr_sim_tpu_torch.utils.gpstime import DateTime, GpsTime, date2gps, sub_gps_time


@dataclass
class Ephemeris:
    """One satellite's broadcast ephemeris record (ephem_t, gpssim.h:101-136)."""

    vflg: int = 0
    t: DateTime = field(default_factory=DateTime)
    toc: GpsTime = field(default_factory=GpsTime)
    toe: GpsTime = field(default_factory=GpsTime)
    iodc: int = 0
    iode: int = 0
    deltan: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    ecc: float = 0.0
    sqrta: float = 0.0
    m0: float = 0.0
    omg0: float = 0.0
    inc0: float = 0.0
    aop: float = 0.0
    omgdot: float = 0.0
    idot: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd: float = 0.0
    svhlth: int = 0
    codeL2: int = 0
    # Working variables (derived at parse time)
    n: float = 0.0
    sq1e2: float = 0.0
    A: float = 0.0
    omgkdot: float = 0.0


@dataclass
class IonoUtc:
    """Klobuchar iono + UTC parameters (ionoutc_t, gpssim.h:138-147)."""

    enable: bool = True
    vflg: bool = False
    alpha0: float = 0.0
    alpha1: float = 0.0
    alpha2: float = 0.0
    alpha3: float = 0.0
    beta0: float = 0.0
    beta1: float = 0.0
    beta2: float = 0.0
    beta3: float = 0.0
    A0: float = 0.0
    A1: float = 0.0
    dtls: int = 0
    tot: int = 0
    wnt: int = 0
    dtlsf: int = 0
    dn: int = 0
    wnlsf: int = 0


def _d2e(s: str) -> str:
    """Replace FORTRAN 'D' exponent designators with 'E' (gpssim.c:763-777)."""
    return s.replace("D", "E")


def _f(line: str, start: int, width: int) -> float:
    return c_atof(_d2e(line[start:start + width]))


def _i(line: str, start: int, width: int) -> int:
    return c_atoi(line[start:start + width])


def read_rinex_nav_all(fname: str, ionoutc: IonoUtc):
    """Parse a RINEX 2 GPS navigation file.

    Returns (eph, neph) where eph is a [EPHEM_ARRAY_SIZE][MAX_SAT] nested list
    of Ephemeris and neph is the number of populated ephemeris sets
    (-1 if the file cannot be opened, matching the C return contract).
    Mutates `ionoutc` with header iono/UTC parameters.
    """
    eph = [[Ephemeris() for _ in range(MAX_SAT)] for _ in range(EPHEM_ARRAY_SIZE)]

    try:
        fp = open(fname, "rt")
    except OSError:
        return eph, -1

    flags = 0x0
    with fp:
        # ---- Header (gpssim.c:843-933) ----
        while True:
            line = fp.readline()
            if not line:
                break
            label = line[60:73]
            if label.startswith("END OF HEADER"):
                break
            elif line[60:69] == "ION ALPHA":
                ionoutc.alpha0 = _f(line, 2, 12)
                ionoutc.alpha1 = _f(line, 14, 12)
                ionoutc.alpha2 = _f(line, 26, 12)
                ionoutc.alpha3 = _f(line, 38, 12)
                flags |= 0x1
            elif line[60:68] == "ION BETA":
                ionoutc.beta0 = _f(line, 2, 12)
                ionoutc.beta1 = _f(line, 14, 12)
                ionoutc.beta2 = _f(line, 26, 12)
                ionoutc.beta3 = _f(line, 38, 12)
                flags |= 0x1 << 1
            elif line[60:69] == "DELTA-UTC":
                ionoutc.A0 = _f(line, 3, 19)
                ionoutc.A1 = _f(line, 22, 19)
                ionoutc.tot = _i(line, 41, 9)
                ionoutc.wnt = _i(line, 50, 9)
                if ionoutc.tot % 4096 == 0:
                    flags |= 0x1 << 2
            elif line[60:72] == "LEAP SECONDS":
                ionoutc.dtls = _i(line, 0, 6)
                flags |= 0x1 << 3

        ionoutc.vflg = flags == 0xF

        # ---- Ephemeris blocks (gpssim.c:935-1160) ----
        g0 = GpsTime(week=-1, sec=0.0)
        ieph = 0

        while True:
            line = fp.readline()
            if not line:
                break

            sv = c_atoi(line[0:2]) - 1
            if not 0 <= sv < MAX_SAT:
                # Unparsable PRN (trailing blank/garbage line): stop, like
                # the reference's fgets loop would at a short line. Never
                # index eph[ieph][-1] (silent PRN-32 corruption).
                break

            t = DateTime()
            t.y = c_atoi(line[3:5]) + 2000
            t.m = c_atoi(line[6:8])
            t.d = c_atoi(line[9:11])
            t.hh = c_atoi(line[12:14])
            t.mm = c_atoi(line[15:17])
            # The reference truncates the seconds field to 2 chars
            # (strncpy 4 then tmp[2]=0; gpssim.c:970-972).
            t.sec = c_atof(line[18:20])

            g = date2gps(t)
            if g0.week == -1:
                g0 = g.copy()

            dt = sub_gps_time(g, g0)
            if dt > SECONDS_IN_HOUR:
                g0 = g.copy()
                ieph += 1  # a new set of ephemerides
                if ieph >= EPHEM_ARRAY_SIZE:
                    break

            e = eph[ieph][sv]
            e.t = t
            e.toc = g.copy()
            e.af0 = _f(line, 22, 19)
            e.af1 = _f(line, 41, 19)
            e.af2 = _f(line, 60, 19)

            # BROADCAST ORBIT - 1
            line = fp.readline()
            if not line:
                break
            e.iode = int(_f(line, 3, 19))
            e.crs = _f(line, 22, 19)
            e.deltan = _f(line, 41, 19)
            e.m0 = _f(line, 60, 19)

            # BROADCAST ORBIT - 2
            line = fp.readline()
            if not line:
                break
            e.cuc = _f(line, 3, 19)
            e.ecc = _f(line, 22, 19)
            e.cus = _f(line, 41, 19)
            e.sqrta = _f(line, 60, 19)

            # BROADCAST ORBIT - 3
            line = fp.readline()
            if not line:
                break
            e.toe.sec = _f(line, 3, 19)
            e.cic = _f(line, 22, 19)
            e.omg0 = _f(line, 41, 19)
            e.cis = _f(line, 60, 19)

            # BROADCAST ORBIT - 4
            line = fp.readline()
            if not line:
                break
            e.inc0 = _f(line, 3, 19)
            e.crc = _f(line, 22, 19)
            e.aop = _f(line, 41, 19)
            e.omgdot = _f(line, 60, 19)

            # BROADCAST ORBIT - 5
            line = fp.readline()
            if not line:
                break
            e.idot = _f(line, 3, 19)
            e.codeL2 = int(_f(line, 22, 19))
            e.toe.week = int(_f(line, 41, 19))

            # BROADCAST ORBIT - 6
            line = fp.readline()
            if not line:
                break
            e.svhlth = int(_f(line, 22, 19))
            if 0 < e.svhlth < 32:
                e.svhlth += 32  # Set MSB to 1 (gpssim.c:1135-1136)
            e.tgd = _f(line, 41, 19)
            e.iodc = int(_f(line, 60, 19))

            # BROADCAST ORBIT - 7 (consumed, unused)
            line = fp.readline()
            if not line:
                break

            e.vflg = 1

            # Derived working variables (gpssim.c:1155-1159)
            e.A = e.sqrta * e.sqrta
            e.n = math.sqrt(GM_EARTH / (e.A * e.A * e.A)) + e.deltan
            e.sq1e2 = math.sqrt(1.0 - e.ecc * e.ecc)
            e.omgkdot = e.omgdot - OMEGA_EARTH

    if g0.week >= 0:
        ieph += 1  # number of populated sets
    return eph, min(ieph, EPHEM_ARRAY_SIZE)


# Field names shipped to the vectorized orbit propagator.
_VEC_FIELDS = (
    "deltan", "cuc", "cus", "cic", "cis", "crc", "crs", "ecc", "sqrta",
    "m0", "omg0", "inc0", "aop", "omgdot", "idot", "af0", "af1", "af2",
    "tgd", "n", "sq1e2", "A", "omgkdot",
)


def eph_field_arrays(eph_row):
    """Struct-of-arrays view of one ephemeris set (a list of Ephemeris).

    Returns a dict of float64 arrays keyed by field name, plus 'toe_sec',
    'toc_sec', and 'vflg' arrays, each shaped [len(eph_row)].
    """
    out = {name: np.array([getattr(e, name) for e in eph_row], dtype=np.float64)
           for name in _VEC_FIELDS}
    out["toe_sec"] = np.array([e.toe.sec for e in eph_row], dtype=np.float64)
    out["toc_sec"] = np.array([e.toc.sec for e in eph_row], dtype=np.float64)
    out["vflg"] = np.array([e.vflg for e in eph_row], dtype=np.int64)
    return out
