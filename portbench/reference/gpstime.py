"""GPS time <-> calendar conversions and week-rollover-safe arithmetic.

Behavioral parity targets: date2gps (gpssim.c:177-200), gps2date
(gpssim.c:202-219), subGpsTime (gpssim.c:779-787), incGpsTime
(gpssim.c:789-811, including the millisecond re-rounding at :796).
"""

from __future__ import annotations

import math

from portbench.reference.cstd import c_round
from dataclasses import dataclass

from portbench.reference.constants import (
    SECONDS_IN_DAY,
    SECONDS_IN_HOUR,
    SECONDS_IN_MINUTE,
    SECONDS_IN_WEEK,
)


@dataclass
class GpsTime:
    week: int = 0
    sec: float = 0.0

    def copy(self) -> "GpsTime":
        return GpsTime(self.week, self.sec)


@dataclass
class DateTime:
    y: int = 0
    m: int = 0
    d: int = 0
    hh: int = 0
    mm: int = 0
    sec: float = 0.0

    def copy(self) -> "DateTime":
        return DateTime(self.y, self.m, self.d, self.hh, self.mm, self.sec)


_DOY = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]


def date2gps(t: DateTime) -> GpsTime:
    """Calendar (UTC as-GPS) -> GPS week/sec; gpssim.c:177-200."""
    ye = t.y - 1980
    # Number of leap days since Jan 5/Jan 6, 1980.
    lpdays = ye // 4 + 1
    if (ye % 4) == 0 and t.m <= 2:
        lpdays -= 1
    de = ye * 365 + _DOY[t.m - 1] + t.d + lpdays - 6
    g = GpsTime()
    g.week = de // 7
    g.sec = float(de % 7) * SECONDS_IN_DAY + t.hh * SECONDS_IN_HOUR \
        + t.mm * SECONDS_IN_MINUTE + t.sec
    return g


def gps2date(g: GpsTime) -> DateTime:
    """GPS week/sec -> calendar date; gpssim.c:202-219."""
    c = int(7 * g.week + math.floor(g.sec / 86400.0) + 2444245.0) + 1537
    d = int((c - 122.1) / 365.25)
    e = 365 * d + d // 4
    f = int((c - e) / 30.6001)
    t = DateTime()
    t.d = c - e - int(30.6001 * f)
    t.m = f - 1 - 12 * (f // 14)
    t.y = d - 4715 - ((7 + t.m) // 10)
    t.hh = (int(g.sec / 3600.0)) % 24
    t.mm = (int(g.sec / 60.0)) % 60
    t.sec = g.sec - 60.0 * math.floor(g.sec / 60.0)
    return t


def sub_gps_time(g1: GpsTime, g0: GpsTime) -> float:
    """g1 - g0 in seconds, week-aware; gpssim.c:779-787."""
    dt = g1.sec - g0.sec
    dt += float(g1.week - g0.week) * SECONDS_IN_WEEK
    return dt


def inc_gps_time(g0: GpsTime, dt: float) -> GpsTime:
    """g0 + dt with millisecond re-rounding; gpssim.c:789-811.

    The reference snaps the result to the nearest millisecond
    (round half away from zero for positive values) to suppress float
    accumulation error (gpssim.c:796).
    """
    g1 = GpsTime(g0.week, g0.sec + dt)
    # C: g1.sec = round(g1.sec*1000.0)/1000.0 with round() = half away from 0.
    s = g1.sec * 1000.0
    g1.sec = float(c_round(s)) / 1000.0  # ms snap (gpssim.c:796)
    while g1.sec >= SECONDS_IN_WEEK:
        g1.sec -= SECONDS_IN_WEEK
        g1.week += 1
    while g1.sec < 0.0:
        g1.sec += SECONDS_IN_WEEK
        g1.week -= 1
    return g1
