"""Navigation-message encoding: subframes, parity, and the 60-word buffer.

Parity targets:
 - eph2sbf (gpssim.c:490-665): ICD-GPS-200 scaling of ephemeris/iono/UTC
   into 5 subframes x 10 x 30-bit words, subframe 4 page 18 (iono/UTC) or
   page 25, subframe 5 page 25, hardcoded leap-second event wnlsf=1929%256,
   dn=7, dtlsf=18 (gpssim.c:580-584), and wn=0 in the subframe-1 image
   (injected at transmit time instead, gpssim.c:534-536).
 - computeChecksum (gpssim.c:693-756): IS-GPS-200 D25-D30 parity with the
   six bit masks, the non-information-bearing-bit solve for words 2 and 10,
   and D30 data inversion.
 - generateNavMsg (gpssim.c:1467-1547): 30-second frame alignment of the
   data-bit reference time, the 60-word buffer (carried subframe 5 + 5 fresh
   subframes), TOW injection into every HOW, week number into subframe 1
   word 3, and parity chaining via the 2 LSBs of the previous word.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.constants import (
    N_DWRD,
    N_DWRD_SBF,
    N_SBF,
    PI,
    POW2_M5,
    POW2_M19,
    POW2_M24,
    POW2_M27,
    POW2_M29,
    POW2_M30,
    POW2_M31,
    POW2_M33,
    POW2_M43,
    POW2_M50,
    POW2_M55,
)
from portbench.reference.cstd import c_round
from portbench.reference.ephemeris import Ephemeris, IonoUtc
from portbench.reference.gpstime import GpsTime


def _trunc(x: float) -> int:
    """C (long)(double) cast: truncation toward zero."""
    return int(x)


def _round_c(x: float) -> int:
    """C round() to int (shared semantics live in utils.cstd.c_round)."""
    return int(c_round(x))


def eph2sbf(eph: Ephemeris, ionoutc: IonoUtc) -> np.ndarray:
    """Pack ephemeris + iono/UTC into the 5x10 subframe image (no parity)."""
    wn = 0
    toe = _trunc(eph.toe.sec / 16.0)
    toc = _trunc(eph.toc.sec / 16.0)
    iode = eph.iode
    iodc = eph.iodc
    deltan = _trunc(eph.deltan / POW2_M43 / PI)
    cuc = _trunc(eph.cuc / POW2_M29)
    cus = _trunc(eph.cus / POW2_M29)
    cic = _trunc(eph.cic / POW2_M29)
    cis = _trunc(eph.cis / POW2_M29)
    crc = _trunc(eph.crc / POW2_M5)
    crs = _trunc(eph.crs / POW2_M5)
    ecc = _trunc(eph.ecc / POW2_M33)
    sqrta = _trunc(eph.sqrta / POW2_M19)
    m0 = _trunc(eph.m0 / POW2_M31 / PI)
    omg0 = _trunc(eph.omg0 / POW2_M31 / PI)
    inc0 = _trunc(eph.inc0 / POW2_M31 / PI)
    aop = _trunc(eph.aop / POW2_M31 / PI)
    omgdot = _trunc(eph.omgdot / POW2_M43 / PI)
    idot = _trunc(eph.idot / POW2_M43 / PI)
    af0 = _trunc(eph.af0 / POW2_M31)
    af1 = _trunc(eph.af1 / POW2_M43)
    af2 = _trunc(eph.af2 / POW2_M55)
    tgd = _trunc(eph.tgd / POW2_M31)
    svhlth = eph.svhlth
    codeL2 = eph.codeL2

    ura = 0
    dataId = 1
    sbf4_page25_svId = 63
    sbf5_page25_svId = 51
    sbf4_page18_svId = 56

    wna = eph.toe.week % 256
    toa = _trunc(eph.toe.sec / 4096.0)

    alpha0 = _round_c(ionoutc.alpha0 / POW2_M30)
    alpha1 = _round_c(ionoutc.alpha1 / POW2_M27)
    alpha2 = _round_c(ionoutc.alpha2 / POW2_M24)
    alpha3 = _round_c(ionoutc.alpha3 / POW2_M24)
    beta0 = _round_c(ionoutc.beta0 / 2048.0)
    beta1 = _round_c(ionoutc.beta1 / 16384.0)
    beta2 = _round_c(ionoutc.beta2 / 65536.0)
    beta3 = _round_c(ionoutc.beta3 / 65536.0)
    A0 = _round_c(ionoutc.A0 / POW2_M30)
    A1 = _round_c(ionoutc.A1 / POW2_M50)
    dtls = ionoutc.dtls
    tot = ionoutc.tot // 4096
    wnt = ionoutc.wnt % 256
    # Scheduled leap-second event (gpssim.c:580-584)
    wnlsf = 1929 % 256
    dn = 7
    dtlsf = 18

    sbf = np.zeros((5, N_DWRD_SBF), dtype=np.uint64)

    def W(x: int) -> np.uint64:
        return np.uint64(x & 0xFFFFFFFF)

    # Subframe 1
    sbf[0][0] = W(0x8B0000 << 6)
    sbf[0][1] = W(0x1 << 8)
    sbf[0][2] = W(((wn & 0x3FF) << 20) | ((codeL2 & 0x3) << 18)
                  | ((ura & 0xF) << 14) | ((svhlth & 0x3F) << 8)
                  | (((iodc >> 8) & 0x3) << 6))
    sbf[0][6] = W((tgd & 0xFF) << 6)
    sbf[0][7] = W(((iodc & 0xFF) << 22) | ((toc & 0xFFFF) << 6))
    sbf[0][8] = W(((af2 & 0xFF) << 22) | ((af1 & 0xFFFF) << 6))
    sbf[0][9] = W((af0 & 0x3FFFFF) << 8)

    # Subframe 2
    sbf[1][0] = W(0x8B0000 << 6)
    sbf[1][1] = W(0x2 << 8)
    sbf[1][2] = W(((iode & 0xFF) << 22) | ((crs & 0xFFFF) << 6))
    sbf[1][3] = W(((deltan & 0xFFFF) << 14) | (((m0 >> 24) & 0xFF) << 6))
    sbf[1][4] = W((m0 & 0xFFFFFF) << 6)
    sbf[1][5] = W(((cuc & 0xFFFF) << 14) | (((ecc >> 24) & 0xFF) << 6))
    sbf[1][6] = W((ecc & 0xFFFFFF) << 6)
    sbf[1][7] = W(((cus & 0xFFFF) << 14) | (((sqrta >> 24) & 0xFF) << 6))
    sbf[1][8] = W((sqrta & 0xFFFFFF) << 6)
    sbf[1][9] = W((toe & 0xFFFF) << 14)

    # Subframe 3
    sbf[2][0] = W(0x8B0000 << 6)
    sbf[2][1] = W(0x3 << 8)
    sbf[2][2] = W(((cic & 0xFFFF) << 14) | (((omg0 >> 24) & 0xFF) << 6))
    sbf[2][3] = W((omg0 & 0xFFFFFF) << 6)
    sbf[2][4] = W(((cis & 0xFFFF) << 14) | (((inc0 >> 24) & 0xFF) << 6))
    sbf[2][5] = W((inc0 & 0xFFFFFF) << 6)
    sbf[2][6] = W(((crc & 0xFFFF) << 14) | (((aop >> 24) & 0xFF) << 6))
    sbf[2][7] = W((aop & 0xFFFFFF) << 6)
    sbf[2][8] = W((omgdot & 0xFFFFFF) << 6)
    sbf[2][9] = W(((iode & 0xFF) << 22) | ((idot & 0x3FFF) << 8))

    if ionoutc.vflg:
        # Subframe 4, page 18: iono/UTC
        sbf[3][0] = W(0x8B0000 << 6)
        sbf[3][1] = W(0x4 << 8)
        sbf[3][2] = W((dataId << 28) | (sbf4_page18_svId << 22)
                      | ((alpha0 & 0xFF) << 14) | ((alpha1 & 0xFF) << 6))
        sbf[3][3] = W(((alpha2 & 0xFF) << 22) | ((alpha3 & 0xFF) << 14)
                      | ((beta0 & 0xFF) << 6))
        sbf[3][4] = W(((beta1 & 0xFF) << 22) | ((beta2 & 0xFF) << 14)
                      | ((beta3 & 0xFF) << 6))
        sbf[3][5] = W((A1 & 0xFFFFFF) << 6)
        sbf[3][6] = W(((A0 >> 8) & 0xFFFFFF) << 6)
        sbf[3][7] = W(((A0 & 0xFF) << 22) | ((tot & 0xFF) << 14)
                      | ((wnt & 0xFF) << 6))
        sbf[3][8] = W(((dtls & 0xFF) << 22) | ((wnlsf & 0xFF) << 14)
                      | ((dn & 0xFF) << 6))
        sbf[3][9] = W((dtlsf & 0xFF) << 22)
    else:
        # Subframe 4, page 25
        sbf[3][0] = W(0x8B0000 << 6)
        sbf[3][1] = W(0x4 << 8)
        sbf[3][2] = W((dataId << 28) | (sbf4_page25_svId << 22))

    # Subframe 5, page 25
    sbf[4][0] = W(0x8B0000 << 6)
    sbf[4][1] = W(0x5 << 8)
    sbf[4][2] = W((dataId << 28) | (sbf5_page25_svId << 22)
                  | ((toa & 0xFF) << 14) | ((wna & 0xFF) << 6))

    return sbf


_BMASK = (0x3B1F3480, 0x1D8F9A40, 0x2EC7CD00,
          0x1763E680, 0x2BB1F340, 0x0B7A89C0)


def compute_checksum(source: int, nib: bool) -> int:
    """IS-GPS-200 word parity (gpssim.c:693-756).

    Bits 31..30 of `source` are D29*/D30* of the previous word; bits 29..6
    the 24 data bits; returns the full 30-bit transmitted word.
    """
    source = int(source)
    d = source & 0x3FFFFFC0
    D29 = (source >> 31) & 0x1
    D30 = (source >> 30) & 0x1

    if nib:  # Solve bits 23/24 so parity-trailing bits are 00 (words 2, 10)
        if (D30 + (_BMASK[4] & d).bit_count()) % 2:
            d ^= 0x1 << 6
        if (D29 + (_BMASK[5] & d).bit_count()) % 2:
            d ^= 0x1 << 7

    D = d
    if D30:
        D ^= 0x3FFFFFC0

    D |= ((D29 + (_BMASK[0] & d).bit_count()) % 2) << 5
    D |= ((D30 + (_BMASK[1] & d).bit_count()) % 2) << 4
    D |= ((D29 + (_BMASK[2] & d).bit_count()) % 2) << 3
    D |= ((D30 + (_BMASK[3] & d).bit_count()) % 2) << 2
    D |= ((D30 + (_BMASK[4] & d).bit_count()) % 2) << 1
    D |= (D29 + (_BMASK[5] & d).bit_count()) % 2

    return D & 0x3FFFFFFF


def generate_nav_msg(g: GpsTime, sbf: np.ndarray, dwrd: np.ndarray,
                     init: bool) -> GpsTime:
    """Fill the 60-word transmit buffer for the frame containing time g.

    Mutates dwrd (shape [N_DWRD] uint64) in place; returns the new data-bit
    reference time g0 (g aligned down to the 30 s frame boundary).
    """
    g0 = GpsTime(g.week, float((int(g.sec + 0.5)) // 30 * 30))

    wn = g0.week % 1024
    tow = int(g0.sec) // 6

    if init:
        prevwrd = 0
        for iwrd in range(N_DWRD_SBF):
            sbfwrd = int(sbf[4][iwrd])
            if iwrd == 1:  # TOW-count into the HOW
                sbfwrd |= (tow & 0x1FFFF) << 13
            sbfwrd |= (prevwrd << 30) & 0xC0000000
            nib = iwrd in (1, 9)
            dwrd[iwrd] = compute_checksum(sbfwrd, nib)
            prevwrd = int(dwrd[iwrd])
    else:
        for iwrd in range(N_DWRD_SBF):
            dwrd[iwrd] = dwrd[N_DWRD_SBF * N_SBF + iwrd]
            prevwrd = int(dwrd[iwrd])

    for isbf in range(N_SBF):
        tow += 1
        for iwrd in range(N_DWRD_SBF):
            sbfwrd = int(sbf[isbf][iwrd])
            if isbf == 0 and iwrd == 2:  # week number into subframe 1 word 3
                sbfwrd |= (wn & 0x3FF) << 20
            if iwrd == 1:  # TOW-count into every HOW
                sbfwrd |= (tow & 0x1FFFF) << 13
            sbfwrd |= (prevwrd << 30) & 0xC0000000
            nib = iwrd in (1, 9)
            dwrd[(isbf + 1) * N_DWRD_SBF + iwrd] = compute_checksum(sbfwrd, nib)
            prevwrd = int(dwrd[(isbf + 1) * N_DWRD_SBF + iwrd])

    return g0


def dwrd_to_bits(dwrd: np.ndarray) -> np.ndarray:
    """Expand the 60-word buffer into 1800 data bits in {-1, +1} (int8).

    Bit index b corresponds to word b//30, bit b%30, matching the
    dataBit extraction `(dwrd[iword]>>(29-ibit)) & 1` (gpssim.c:1345,2236).
    One bit lasts 20 ms, so this table covers 36 s of signal.
    """
    words = dwrd.astype(np.uint64)[:, None]
    shifts = np.uint64(29) - np.arange(30, dtype=np.uint64)[None, :]
    bits = ((words >> shifts) & np.uint64(1)).astype(np.int8)
    return (bits * 2 - 1).reshape(-1)
