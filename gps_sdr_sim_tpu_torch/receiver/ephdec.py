"""Decode broadcast ephemeris from received subframes 1-3.

Exact inverse of the encoder (models/navmsg.py::eph2sbf; reference
gpssim.c:490-665): unpacks the ICD-GPS-200 bit fields and applies the
POW2_M* scalings, reconstructing an `Ephemeris` usable by models/orbit.py.
"""

from __future__ import annotations

from typing import Dict, Optional

import math
import numpy as np

from gps_sdr_sim_tpu_torch.constants import (GM_EARTH, OMEGA_EARTH, PI, POW2_M5,
                                       POW2_M19, POW2_M24, POW2_M27,
                                       POW2_M29, POW2_M30, POW2_M31,
                                       POW2_M33, POW2_M43, POW2_M50,
                                       POW2_M55)
from gps_sdr_sim_tpu_torch.models.ephemeris import Ephemeris
from gps_sdr_sim_tpu_torch.receiver.navdec import Subframe
from gps_sdr_sim_tpu_torch.utils.gpstime import GpsTime


def _s(val: int, bits: int) -> int:
    """Two's-complement sign extension."""
    return val - (1 << bits) if val & (1 << (bits - 1)) else val


# Decoded field = raw * scale * (1 + 2^-48). The reference's POW2_M*
# constants are truncated decimal literals a few ulps away from the exact
# powers of two; without the bias, re-encoding (eph2sbf's trunc(x / c))
# can land at raw-1 when the literal sits above the true power. 2^-48
# relative (~nanometers on any orbit quantity) keeps trunc() exact for all
# field widths (<= 32 bits) and both signs.
_BIAS = 1.0 + 2.0 ** -48


def _q(raw: int, *scales: float) -> float:
    v = float(raw) * _BIAS
    for s in scales:
        v *= s
    return v


def _data24(sbf: Subframe) -> np.ndarray:
    """The 10 de-inverted 24-bit data fields of a parity-valid subframe."""
    words = sbf.words.astype(np.int64)
    d30s = np.concatenate(([0], words[:-1] & 1))  # word 1's D30* is bits[p-1]
    # frame_sync validated parity, which includes the D30* of the word
    # before the subframe; within the subframe the chain is words[:-1].
    d = (words & 0x3FFFFFC0) ^ np.where(d30s == 1, 0x3FFFFFC0, 0)
    return (d >> 6) & 0xFFFFFF


def decode_ephemeris(sbf1: Subframe, sbf2: Subframe, sbf3: Subframe,
                     d30_before_sbf1: int = 0) -> Ephemeris:
    """Assemble an Ephemeris from decoded subframes 1, 2, 3.

    `d30_before_sbf1`: D30* of the word preceding subframe 1's TLM (bit
    p-1 in the stream), needed to de-invert word 1; navdec stores it
    implicitly by validating parity, and word 1 carries no ephemeris
    fields, so the default is fine.
    """
    assert (sbf1.sbf_id, sbf2.sbf_id, sbf3.sbf_id) == (1, 2, 3)
    d1, d2, d3 = _data24(sbf1), _data24(sbf2), _data24(sbf3)

    e = Ephemeris()
    e.vflg = 1

    # --- subframe 1 (eph2sbf words 3, 7, 8, 9, 10) ---
    wn = int(d1[2] >> 14) & 0x3FF
    e.codeL2 = int(d1[2] >> 12) & 0x3
    e.svhlth = int(d1[2] >> 2) & 0x3F
    iodc_hi = int(d1[2]) & 0x3
    e.tgd = _q(_s(int(d1[6]) & 0xFF, 8), POW2_M31)
    e.iodc = (iodc_hi << 8) | (int(d1[7] >> 16) & 0xFF)
    toc = (int(d1[7]) & 0xFFFF) * 16.0
    e.af2 = _q(_s(int(d1[8] >> 16) & 0xFF, 8), POW2_M55)
    e.af1 = _q(_s(int(d1[8]) & 0xFFFF, 16), POW2_M43)
    e.af0 = _q(_s(int(d1[9] >> 2) & 0x3FFFFF, 22), POW2_M31)

    # --- subframe 2 ---
    e.iode = int(d2[2] >> 16) & 0xFF
    e.crs = _q(_s(int(d2[2]) & 0xFFFF, 16), POW2_M5)
    e.deltan = _q(_s(int(d2[3] >> 8) & 0xFFFF, 16), POW2_M43, PI)
    e.m0 = _q(_s(((int(d2[3]) & 0xFF) << 24) | int(d2[4]), 32), POW2_M31, PI)
    e.cuc = _q(_s(int(d2[5] >> 8) & 0xFFFF, 16), POW2_M29)
    e.ecc = _q(((int(d2[5]) & 0xFF) << 24) | int(d2[6]), POW2_M33)
    e.cus = _q(_s(int(d2[7] >> 8) & 0xFFFF, 16), POW2_M29)
    e.sqrta = _q(((int(d2[7]) & 0xFF) << 24) | int(d2[8]), POW2_M19)
    toe = (int(d2[9] >> 8) & 0xFFFF) * 16.0

    # --- subframe 3 ---
    e.cic = _q(_s(int(d3[2] >> 8) & 0xFFFF, 16), POW2_M29)
    e.omg0 = _q(_s(((int(d3[2]) & 0xFF) << 24) | int(d3[3]), 32), POW2_M31, PI)
    e.cis = _q(_s(int(d3[4] >> 8) & 0xFFFF, 16), POW2_M29)
    e.inc0 = _q(_s(((int(d3[4]) & 0xFF) << 24) | int(d3[5]), 32), POW2_M31, PI)
    e.crc = _q(_s(int(d3[6] >> 8) & 0xFFFF, 16), POW2_M5)
    e.aop = _q(_s(((int(d3[6]) & 0xFF) << 24) | int(d3[7]), 32), POW2_M31, PI)
    e.omgdot = _q(_s(int(d3[8]), 24), POW2_M43, PI)
    iode3 = int(d3[9] >> 16) & 0xFF
    e.idot = _q(_s(int(d3[9] >> 2) & 0x3FFF, 14), POW2_M43, PI)
    if iode3 != e.iode:
        raise ValueError(f"IODE mismatch between subframes 2/3: "
                         f"{e.iode} vs {iode3}")
    if e.iode != (e.iodc & 0xFF):
        # ICD-GPS-200: IODE must equal the 8 LSBs of IODC; a mismatch means
        # subframe 1 came from a different (e.g. pre-cutover) data set.
        raise ValueError(f"IODE {e.iode} != IODC&0xFF {e.iodc & 0xFF}")

    # Subframe 1 carries only the 10 LSBs of the week; the GPS era (1024-
    # week rollover) is not recoverable from the signal. toe/toc keep the
    # mod-1024 week — all half-week-wrapped arithmetic (satpos, clock
    # polynomials) is era-independent, but callers needing absolute time
    # must add the era themselves.
    week = wn
    e.toc = GpsTime(week, toc)
    e.toe = GpsTime(week, toe)

    # Working variables (models/ephemeris.py:260-263)
    e.A = e.sqrta * e.sqrta
    e.n = math.sqrt(GM_EARTH / (e.A ** 3)) + e.deltan
    e.sq1e2 = math.sqrt(1.0 - e.ecc * e.ecc)
    e.omgkdot = e.omgdot - OMEGA_EARTH
    return e


from dataclasses import dataclass as _dataclass


@_dataclass
class EphSet:
    """One complete broadcast data set recovered from a capture."""

    eph: Ephemeris
    iode: int
    first_bit: int  # bit index of the set's earliest subframe
    last_bit: int   # bit index just past its latest subframe (fully
                    # received once the stream reaches this bit)


def decode_sets(subframes) -> "list[EphSet]":
    """ALL consistent (1,2,3) ephemeris sets in a capture, in bit order.

    A capture that crosses a 2 h broadcast data-set cutover
    (gpssim.c:2307-2326) carries frames from two IODEs; grouping subframes
    by their issue-of-data keys yields one Ephemeris per complete set, so
    long captures keep a usable (and current) ephemeris on both sides of
    the change instead of failing the cross-set consistency check.
    """
    s1: Dict[int, Subframe] = {}  # IODC & 0xFF -> first subframe 1
    s2: Dict[int, Subframe] = {}  # IODE -> first subframe 2
    s3: Dict[int, Subframe] = {}  # IODE -> first subframe 3
    for s in sorted(subframes, key=lambda s: s.bit_index):
        d = _data24(s)
        if s.sbf_id == 1:
            key = int(d[7] >> 16) & 0xFF  # IODC & 0xFF (== IODE of the set)
            s1.setdefault(key, s)
        elif s.sbf_id == 2:
            s2.setdefault(int(d[2] >> 16) & 0xFF, s)
        elif s.sbf_id == 3:
            s3.setdefault(int(d[9] >> 16) & 0xFF, s)

    out = []
    for iode, sbf2 in s2.items():
        if iode not in s1 or iode not in s3:
            continue
        try:
            eph = decode_ephemeris(s1[iode], sbf2, s3[iode])
        except ValueError:
            continue
        members = (s1[iode], sbf2, s3[iode])
        out.append(EphSet(
            eph=eph, iode=iode,
            first_bit=min(m.bit_index for m in members),
            last_bit=max(m.bit_index for m in members) + 300))
    out.sort(key=lambda e: e.first_bit)
    return out


def decode_all(subframes) -> Optional[Ephemeris]:
    """The earliest complete ephemeris set in a capture (or None).

    Returns None when no consistent (1,2,3) set exists — callers skip the
    channel rather than abort. Captures spanning an IODE change still
    succeed because sets are grouped by issue-of-data (decode_sets).
    """
    sets = decode_sets(subframes)
    return sets[0].eph if sets else None


def decode_ionoutc(sbf4: Subframe):
    """Decode iono/UTC from subframe 4 page 18 (eph2sbf gpssim.c:622-650).

    Returns an IonoUtc, or None if this subframe 4 is the empty page 25
    (no ION ALPHA/BETA in the source RINEX header).
    """
    from gps_sdr_sim_tpu_torch.models.ephemeris import IonoUtc

    assert sbf4.sbf_id == 4
    d = _data24(sbf4)
    sv_id = int(d[2] >> 16) & 0x3F
    if sv_id != 56:  # page 18 carries iono/UTC; 63 is the filler page 25
        return None

    io = IonoUtc()
    io.vflg = True
    io.alpha0 = _q(_s(int(d[2] >> 8) & 0xFF, 8), POW2_M30)
    io.alpha1 = _q(_s(int(d[2]) & 0xFF, 8), POW2_M27)
    io.alpha2 = _q(_s(int(d[3] >> 16) & 0xFF, 8), POW2_M24)
    io.alpha3 = _q(_s(int(d[3] >> 8) & 0xFF, 8), POW2_M24)
    io.beta0 = float(_s(int(d[3]) & 0xFF, 8)) * 2048.0
    io.beta1 = float(_s(int(d[4] >> 16) & 0xFF, 8)) * 16384.0
    io.beta2 = float(_s(int(d[4] >> 8) & 0xFF, 8)) * 65536.0
    io.beta3 = float(_s(int(d[4]) & 0xFF, 8)) * 65536.0
    io.A1 = _q(_s(int(d[5]), 24), POW2_M50)
    io.A0 = _q(_s((int(d[6]) << 8) | (int(d[7] >> 16) & 0xFF), 32), POW2_M30)
    io.tot = (int(d[7] >> 8) & 0xFF) * 4096
    io.wnt = int(d[7]) & 0xFF
    io.dtls = _s(int(d[8] >> 16) & 0xFF, 8)
    io.wnlsf = int(d[8] >> 8) & 0xFF
    io.dn = int(d[8]) & 0xFF
    io.dtlsf = _s(int(d[9] >> 16) & 0xFF, 8)
    return io
