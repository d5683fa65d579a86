"""GNSS observables: pseudorange, range-rate, az/el, visibility (vectorized).

Parity targets: computeRange (gpssim.c:1253-1310) — light-time
back-extrapolation, Sagnac (Earth-rotation) correction, pseudorange =
range - c*clk, range-rate = dot(vel, los)/range, az/el via the receiver's
local-tangent frame, plus Klobuchar delay added onto the pseudorange — and
checkSatVisibility (gpssim.c:1549-1570), which uses the *instantaneous*
(non-light-time-corrected) satellite position.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.constants import OMEGA_EARTH, R2D, SPEED_OF_LIGHT
from portbench.reference.atmosphere import ionospheric_delay
from portbench.reference.ephemeris import IonoUtc
from portbench.reference.orbit import satpos
from portbench.reference.coord import (
    dot_prod,
    ecef2neu,
    ltcmat,
    neu2azel,
    norm_vect,
    xyz2llh,
)


def compute_range(eph: dict, ionoutc: IonoUtc, g_sec, xyz,
                  llh=None, tmat=None):
    """Pseudorange observables for satellites in `eph` at times `g_sec`.

    xyz: receiver ECEF, shape broadcastable to (..., 3). llh/tmat: the
    receiver's geodetic position and local-tangent matrix; pass them when
    calling once per satellite for the same positions (the iterative
    xyz2llh is the expensive part), or leave None to derive from xyz.
    Returns a dict of arrays: range (pseudorange incl. iono), rate,
    d (geometric distance), azel (..., 2), iono_delay.
    """
    g_sec = np.asarray(g_sec, dtype=np.float64)
    xyz = np.asarray(xyz, dtype=np.float64)

    pos, vel, clk = satpos(eph, g_sec)

    # Receiver-to-satellite vector and light time.
    los = pos - xyz
    tau = norm_vect(los) / SPEED_OF_LIGHT

    # Extrapolate the satellite position backwards to the transmission time.
    pos = pos - vel * tau[..., None]

    # Earth rotation (Sagnac) correction.
    xrot = pos[..., 0] + pos[..., 1] * OMEGA_EARTH * tau
    yrot = pos[..., 1] - pos[..., 0] * OMEGA_EARTH * tau
    pos = np.stack([xrot, yrot, pos[..., 2]], axis=-1)

    # New observer-to-satellite vector and geometric range.
    los = pos - xyz
    rng = norm_vect(los)

    pseudorange = rng - SPEED_OF_LIGHT * clk[..., 0]
    rate = dot_prod(vel, los) / rng

    # Azimuth/elevation in the receiver's local-tangent frame.
    if llh is None:
        llh = xyz2llh(xyz)
    if tmat is None:
        tmat = ltcmat(llh)
    neu = ecef2neu(los, tmat)
    azel = neu2azel(neu)

    iono = ionospheric_delay(ionoutc, g_sec, llh, azel)
    pseudorange = pseudorange + iono

    return {
        "range": pseudorange,
        "rate": rate,
        "d": rng,
        "azel": azel,
        "iono_delay": iono,
        "g_sec": np.broadcast_to(g_sec, rng.shape).copy(),
    }


def sat_visibility(eph: dict, g_sec, xyz, elv_mask_deg: float = 0.0):
    """Visibility check per satellite (gpssim.c:1549-1570).

    Returns (visible, azel): visible is a bool array (False also for
    invalid ephemerides), azel the instantaneous az/el (..., 2).
    """
    g_sec = np.asarray(g_sec, dtype=np.float64)
    xyz = np.asarray(xyz, dtype=np.float64)

    llh = xyz2llh(xyz)
    tmat = ltcmat(llh)

    pos, _vel, _clk = satpos(eph, g_sec)
    los = pos - xyz
    neu = ecef2neu(los, tmat)
    azel = neu2azel(neu)

    visible = (azel[..., 1] * R2D > elv_mask_deg) & (eph["vflg"] == 1)
    return visible, azel
