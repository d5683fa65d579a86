"""Broadcast-ephemeris orbit propagation (position, velocity, clock).

Parity target: satpos (gpssim.c:379-484) — Kepler's equation solved by
Newton iteration to |ek - ekold| <= 1e-14 with per-element stopping,
harmonic corrections, NGS bc_velo velocity terms, the relativistic clock
correction, and the SV clock polynomial including -tgd.

Vectorized over arbitrary leading batch shape in float64 on the host: the
per-epoch observable path runs ~1e5 evaluations per scenario, which is
microseconds as NumPy array code and irrelevant next to sample synthesis.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.constants import (
    OMEGA_EARTH,
    SECONDS_IN_HALF_WEEK,
    SECONDS_IN_WEEK,
)


def _wrap_half_week(tk: np.ndarray) -> np.ndarray:
    tk = np.where(tk > SECONDS_IN_HALF_WEEK, tk - SECONDS_IN_WEEK, tk)
    tk = np.where(tk < -SECONDS_IN_HALF_WEEK, tk + SECONDS_IN_WEEK, tk)
    return tk


def satpos(eph: dict, g_sec):
    """Satellite position/velocity/clock at GPS seconds `g_sec`.

    `eph` is a dict of float64 arrays (from eph_field_arrays) and `g_sec` an
    array; all inputs broadcast together. Returns (pos, vel, clk) with
    trailing dims 3, 3, 2.
    """
    g_sec = np.asarray(g_sec, dtype=np.float64)
    tk = _wrap_half_week(g_sec - eph["toe_sec"])

    mk = eph["m0"] + eph["n"] * tk
    ecc = eph["ecc"]

    # Newton iteration with per-element stopping at |ek - ekold| <= 1e-14;
    # the final OneMinusecosE must come from the last *executed* update for
    # each element (gpssim.c:419-425).
    shape = np.broadcast_shapes(np.shape(mk), np.shape(ecc))
    ek = np.broadcast_to(mk, shape).copy()
    ecc_b = np.broadcast_to(ecc, shape)
    one_minus_ecos = np.zeros(shape, dtype=np.float64)
    active = np.ones(shape, dtype=bool)
    for _ in range(60):
        ekold = ek
        omc_new = 1.0 - ecc_b * np.cos(ekold)
        ek_new = ekold + (np.broadcast_to(mk, shape) - ekold
                          + ecc_b * np.sin(ekold)) / omc_new
        one_minus_ecos = np.where(active, omc_new, one_minus_ecos)
        ek = np.where(active, ek_new, ek)
        active = active & (np.abs(ek_new - ekold) > 1.0e-14)
        if not active.any():
            break

    sek = np.sin(ek)
    cek = np.cos(ek)
    ekdot = eph["n"] / one_minus_ecos

    relativistic = -4.442807633e-10 * ecc * eph["sqrta"] * sek

    pk = np.arctan2(eph["sq1e2"] * sek, cek - ecc) + eph["aop"]
    pkdot = eph["sq1e2"] * ekdot / one_minus_ecos

    s2pk = np.sin(2.0 * pk)
    c2pk = np.cos(2.0 * pk)

    uk = pk + eph["cus"] * s2pk + eph["cuc"] * c2pk
    suk = np.sin(uk)
    cuk = np.cos(uk)
    ukdot = pkdot * (1.0 + 2.0 * (eph["cus"] * c2pk - eph["cuc"] * s2pk))

    rk = eph["A"] * one_minus_ecos + eph["crc"] * c2pk + eph["crs"] * s2pk
    rkdot = eph["A"] * ecc * sek * ekdot + 2.0 * pkdot * (
        eph["crs"] * c2pk - eph["crc"] * s2pk)

    ik = eph["inc0"] + eph["idot"] * tk + eph["cic"] * c2pk + eph["cis"] * s2pk
    sik = np.sin(ik)
    cik = np.cos(ik)
    ikdot = eph["idot"] + 2.0 * pkdot * (eph["cis"] * c2pk - eph["cic"] * s2pk)

    xpk = rk * cuk
    ypk = rk * suk
    xpkdot = rkdot * cuk - ypk * ukdot
    ypkdot = rkdot * suk + xpk * ukdot

    ok = eph["omg0"] + tk * eph["omgkdot"] - OMEGA_EARTH * eph["toe_sec"]
    sok = np.sin(ok)
    cok = np.cos(ok)

    pos = np.empty(np.broadcast_shapes(shape, np.shape(ok)) + (3,), np.float64)
    pos[..., 0] = xpk * cok - ypk * cik * sok
    pos[..., 1] = xpk * sok + ypk * cik * cok
    pos[..., 2] = ypk * sik

    tmp = ypkdot * cik - ypk * sik * ikdot

    vel = np.empty_like(pos)
    vel[..., 0] = -eph["omgkdot"] * pos[..., 1] + xpkdot * cok - tmp * sok
    vel[..., 1] = eph["omgkdot"] * pos[..., 0] + xpkdot * sok + tmp * cok
    vel[..., 2] = ypk * cik * ikdot + ypkdot * sik

    # Satellite clock correction (gpssim.c:472-481)
    tk2 = _wrap_half_week(g_sec - eph["toc_sec"])
    clk = np.empty(pos.shape[:-1] + (2,), np.float64)
    clk[..., 0] = (eph["af0"] + tk2 * (eph["af1"] + tk2 * eph["af2"])
                   + relativistic - eph["tgd"])
    clk[..., 1] = eph["af1"] + 2.0 * tk2 * eph["af2"]
    return pos, vel, clk
