"""Klobuchar ionospheric delay model (vectorized, float64).

Parity target: ionosphericDelay (gpssim.c:1170-1245): semi-circle units,
obliquity F = 1 + 16*(0.53 - E)^3, AMP/PER clamps, the cosine expansion for
|X| < 1.57, the F*5ns*c fallback when iono parameters are absent, and 0.0
when disabled via the -i flag.
"""

from __future__ import annotations

import numpy as np

from gps_sdr_sim_tpu_torch.constants import PI, SECONDS_IN_DAY, SPEED_OF_LIGHT
from gps_sdr_sim_tpu_torch.models.ephemeris import IonoUtc


def ionospheric_delay(ionoutc: IonoUtc, g_sec, llh, azel):
    """Ionospheric delay in meters.

    g_sec: GPS seconds-of-week array; llh: (...,3) receiver geodetic
    position; azel: (...,2) satellite azimuth/elevation. Broadcasts.
    """
    g_sec = np.asarray(g_sec, dtype=np.float64)
    llh = np.asarray(llh, dtype=np.float64)
    azel = np.asarray(azel, dtype=np.float64)

    if not ionoutc.enable:
        shape = np.broadcast_shapes(np.shape(g_sec), llh.shape[:-1],
                                    azel.shape[:-1])
        return np.zeros(shape, dtype=np.float64)

    E = azel[..., 1] / PI
    phi_u = llh[..., 0] / PI
    lam_u = llh[..., 1] / PI

    # Obliquity factor (gpssim.c:1183)
    F = 1.0 + 16.0 * (0.53 - E) ** 3.0

    if not ionoutc.vflg:
        shape = np.broadcast_shapes(np.shape(g_sec), llh.shape[:-1],
                                    azel.shape[:-1])
        return np.broadcast_to(F * 5.0e-9 * SPEED_OF_LIGHT, shape).copy()

    # Earth's central angle between user and the iono-pierce projection
    psi = 0.0137 / (E + 0.11) - 0.022

    phi_i = phi_u + psi * np.cos(azel[..., 0])
    phi_i = np.clip(phi_i, -0.416, 0.416)

    lam_i = lam_u + psi * np.sin(azel[..., 0]) / np.cos(phi_i * PI)

    # Geomagnetic latitude (mean iono height 350 km), semi-circles
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * PI)
    phi_m2 = phi_m * phi_m
    phi_m3 = phi_m2 * phi_m

    AMP = (ionoutc.alpha0 + ionoutc.alpha1 * phi_m
           + ionoutc.alpha2 * phi_m2 + ionoutc.alpha3 * phi_m3)
    AMP = np.maximum(AMP, 0.0)

    PER = (ionoutc.beta0 + ionoutc.beta1 * phi_m
           + ionoutc.beta2 * phi_m2 + ionoutc.beta3 * phi_m3)
    PER = np.maximum(PER, 72000.0)

    # Local time (sec), folded into [0, 86400)
    t = SECONDS_IN_DAY / 2.0 * lam_i + g_sec
    t = t - SECONDS_IN_DAY * np.floor(t / SECONDS_IN_DAY)

    # Phase (radians)
    X = 2.0 * PI * (t - 50400.0) / PER
    X2 = X * X
    X4 = X2 * X2

    expansion = F * (5.0e-9 + AMP * (1.0 - X2 / 2.0 + X4 / 24.0)) * SPEED_OF_LIGHT
    fallback = F * 5.0e-9 * SPEED_OF_LIGHT
    return np.where(np.abs(X) < 1.57, expansion, fallback)
