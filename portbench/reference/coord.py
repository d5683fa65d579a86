"""WGS84 geodesy, vectorized over leading batch dimensions (float64).

Behavioral parity targets: xyz2llh (gpssim.c:225-273, iterative with eps=1e-3
and per-element stopping), llh2xyz (gpssim.c:279-311), ltcmat
(gpssim.c:317-338), ecef2neu (gpssim.c:345-352), neu2azel (gpssim.c:358-370).

All functions take arrays shaped (..., 3) and return matching batch shapes.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.constants import PI, WGS84_ECCENTRICITY, WGS84_RADIUS


def norm_vect(x: np.ndarray) -> np.ndarray:
    """Euclidean norm over the last axis (gpssim.c:113-116)."""
    x = np.asarray(x, dtype=np.float64)
    return np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2)


def dot_prod(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Dot product over the last axis (gpssim.c:123-126)."""
    return (x1[..., 0] * x2[..., 0] + x1[..., 1] * x2[..., 1]
            + x1[..., 2] * x2[..., 2])


def xyz2llh(xyz: np.ndarray) -> np.ndarray:
    """ECEF -> lat/lon/height (radians, meters).

    Replicates the reference's fixed-point iteration exactly: each element
    iterates `dz := n*e2*slat` until |dz - dz_new| < 1e-3, freezing its own
    dz at its own stopping point (gpssim.c:254-266). Elements with
    |xyz| < 1e-3 return (0, 0, -a) (gpssim.c:237-245).
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    a = WGS84_RADIUS
    e = WGS84_ECCENTRICITY
    eps = 1.0e-3
    e2 = e * e

    x = xyz[..., 0]
    y = xyz[..., 1]
    z = xyz[..., 2]
    invalid = norm_vect(xyz) < eps

    rho2 = x * x + y * y
    dz = e2 * z

    converged = np.zeros(np.shape(dz), dtype=bool) | invalid
    # The loop converges in a handful of iterations; 100 is a hard backstop.
    for _ in range(100):
        zdz = z + dz
        nh = np.sqrt(rho2 + zdz * zdz)
        with np.errstate(invalid="ignore", divide="ignore"):
            slat = zdz / nh
            n = a / np.sqrt(1.0 - e2 * slat * slat)
        dz_new = n * e2 * slat
        now = np.abs(dz - dz_new) < eps
        converged = converged | now
        dz = np.where(converged, dz, dz_new)
        if np.all(converged):
            break

    zdz = z + dz
    nh = np.sqrt(rho2 + zdz * zdz)
    with np.errstate(invalid="ignore", divide="ignore"):
        slat = zdz / nh
        n = a / np.sqrt(1.0 - e2 * slat * slat)

    llh = np.empty(np.shape(dz) + (3,), dtype=np.float64)
    llh[..., 0] = np.where(invalid, 0.0, np.arctan2(zdz, np.sqrt(rho2)))
    llh[..., 1] = np.where(invalid, 0.0, np.arctan2(y, x))
    llh[..., 2] = np.where(invalid, -a, nh - n)
    return llh


def llh2xyz(llh: np.ndarray) -> np.ndarray:
    """Lat/lon/height (radians, meters) -> ECEF (gpssim.c:279-311)."""
    llh = np.asarray(llh, dtype=np.float64)
    a = WGS84_RADIUS
    e = WGS84_ECCENTRICITY
    e2 = e * e

    clat = np.cos(llh[..., 0])
    slat = np.sin(llh[..., 0])
    clon = np.cos(llh[..., 1])
    slon = np.sin(llh[..., 1])
    d = e * slat

    n = a / np.sqrt(1.0 - d * d)
    nph = n + llh[..., 2]

    tmp = nph * clat
    xyz = np.empty(llh.shape, dtype=np.float64)
    xyz[..., 0] = tmp * clon
    xyz[..., 1] = tmp * slon
    xyz[..., 2] = ((1.0 - e2) * n + llh[..., 2]) * slat
    return xyz


def ltcmat(llh: np.ndarray) -> np.ndarray:
    """Local-tangent-coordinate rotation matrix, shape (..., 3, 3)
    (gpssim.c:317-338)."""
    llh = np.asarray(llh, dtype=np.float64)
    slat = np.sin(llh[..., 0])
    clat = np.cos(llh[..., 0])
    slon = np.sin(llh[..., 1])
    clon = np.cos(llh[..., 1])

    t = np.empty(llh.shape[:-1] + (3, 3), dtype=np.float64)
    t[..., 0, 0] = -slat * clon
    t[..., 0, 1] = -slat * slon
    t[..., 0, 2] = clat
    t[..., 1, 0] = -slon
    t[..., 1, 1] = clon
    t[..., 1, 2] = 0.0
    t[..., 2, 0] = clat * clon
    t[..., 2, 1] = clat * slon
    t[..., 2, 2] = slat
    return t


def ecef2neu(xyz: np.ndarray, t: np.ndarray) -> np.ndarray:
    """ECEF vector -> North/East/Up via the ltcmat matrix (gpssim.c:345-352).

    Matches the C operation order (row-by-row dot products).
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    neu = np.empty(np.broadcast_shapes(xyz.shape, t.shape[:-1]), dtype=np.float64)
    for i in range(3):
        neu[..., i] = (t[..., i, 0] * xyz[..., 0] + t[..., i, 1] * xyz[..., 1]
                       + t[..., i, 2] * xyz[..., 2])
    return neu


def neu2azel(neu: np.ndarray) -> np.ndarray:
    """NEU -> (azimuth, elevation) radians, az in [0, 2*PI)
    (gpssim.c:358-370). Returns shape (..., 2)."""
    neu = np.asarray(neu, dtype=np.float64)
    azel = np.empty(neu.shape[:-1] + (2,), dtype=np.float64)
    az = np.arctan2(neu[..., 1], neu[..., 0])
    az = np.where(az < 0.0, az + 2.0 * PI, az)
    azel[..., 0] = az
    ne = np.sqrt(neu[..., 0] ** 2 + neu[..., 1] ** 2)
    azel[..., 1] = np.arctan2(neu[..., 2], ne)
    return azel
