"""Receiver antenna pattern and per-channel signal gain.

Parity targets: ant_pat_db (gpssim.c:86-91), dB->linear conversion
(gpssim.c:2142-2143), and the amplitude model (gpssim.c:2178-2186):
path_loss = 20200000/rho_d, boresight index (90 - el)/5, and
gain = (int)(path_loss * ant_gain * 128).
"""

from __future__ import annotations

import numpy as np

from portbench.reference.constants import R2D

# Attenuation in dB for boresight angle 0:5:180 degrees (37 entries).
ANT_PAT_DB = np.array([
    0.00, 0.00, 0.22, 0.44, 0.67, 1.11, 1.56, 2.00, 2.44, 2.89, 3.56, 4.22,
    4.89, 5.56, 6.22, 6.89, 7.56, 8.22, 8.89, 9.78, 10.67, 11.56, 12.44,
    13.33, 14.44, 15.56, 16.67, 17.78, 18.89, 20.00, 21.33, 22.67, 24.00,
    25.56, 27.33, 29.33, 31.56,
], dtype=np.float64)

ANT_PAT = np.power(10.0, -ANT_PAT_DB / 20.0)


def signal_gain(d: np.ndarray, el: np.ndarray) -> np.ndarray:
    """Integer channel gain scaled by 2^7 (gpssim.c:2178-2186).

    d: geometric distance (m); el: elevation (radians). Vectorized.
    """
    d = np.asarray(d, dtype=np.float64)
    el = np.asarray(el, dtype=np.float64)
    path_loss = 20200000.0 / d
    ibs = ((90.0 - el * R2D) / 5.0).astype(np.int64)  # C (int) truncation
    ant_gain = ANT_PAT[ibs]
    return (path_loss * ant_gain * 128.0).astype(np.int64)
