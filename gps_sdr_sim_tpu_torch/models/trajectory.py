"""Receiver trajectory inputs: ECEF user-motion CSV and NMEA GGA streams.

Parity targets: readUserMotion (gpssim.c:1358-1384, 10 Hz `t,x,y,z` ECEF
rows) and readNmeaGGA (gpssim.c:1386-1465, $GPGGA -> LLH (+geoid
separation) -> ECEF). Unlike the reference, the maximum point count is a
runtime parameter instead of the USER_MOTION_SIZE compile-time define.
"""

from __future__ import annotations

import numpy as np

from gps_sdr_sim_tpu_torch.constants import R2D, USER_MOTION_SIZE
from gps_sdr_sim_tpu_torch.utils.coord import llh2xyz
from gps_sdr_sim_tpu_torch.utils.cstd import c_atof, c_sscanf_doubles


def read_user_motion(filename: str, max_points: int = USER_MOTION_SIZE) -> np.ndarray:
    """Read a 10 Hz ECEF motion CSV; returns [N, 3] float64 positions.

    Row index IS the 0.1 s epoch index, so the reference's exact sscanf
    semantics matter for time alignment (gpssim.c:1365-1377): every line
    produces a row; fields that fail to convert keep the previous line's
    values (sscanf stores only the converted prefix), and only a line
    where no conversion happens at all before end-of-input (sscanf ==
    EOF, i.e. blank) truncates the file. A garbage FIRST line reads
    uninitialized stack in the reference (UB); here those fields are 0.
    """
    rows = []
    t = x = y = z = 0.0
    with open(filename, "rt") as fp:
        for line in fp:
            if len(rows) >= max_points:
                break
            vals = c_sscanf_doubles(line, 4)
            if not vals and not line.strip():
                break  # sscanf returns EOF on an all-whitespace line
            fields = [t, x, y, z]
            fields[:len(vals)] = vals
            t, x, y, z = fields
            rows.append((x, y, z))
    return np.array(rows, dtype=np.float64).reshape(-1, 3)


def read_nmea_gga(filename: str, max_points: int = USER_MOTION_SIZE) -> np.ndarray:
    """Read $GPGGA sentences; returns [N, 3] float64 ECEF positions."""
    rows = []
    with open(filename, "rt") as fp:
        for line in fp:
            token = line.split(",")
            if len(token) < 12 or len(token[0]) < 6 or token[0][3:6] != "GGA":
                continue
            # Skip no-fix sentences (empty lat/lon or fix quality 0): the
            # reference crashes on these (strtok NULL); emitting the
            # (0N, 0E) origin would corrupt the trajectory.
            if not token[2] or not token[4] or token[6] in ("", "0"):
                continue
            # Latitude ddmm.mmmm
            lat = c_atof(token[2][:2]) + c_atof(token[2][2:]) / 60.0
            if token[3].startswith("S"):
                lat = -lat
            lat /= R2D
            # Longitude dddmm.mmmm
            lon = c_atof(token[4][:3]) + c_atof(token[4][3:]) / 60.0
            if token[5].startswith("W"):
                lon = -lon
            lon /= R2D
            # Altitude above MSL + geoid separation above WGS84
            hgt = c_atof(token[9]) + c_atof(token[11])

            rows.append(llh2xyz(np.array([lat, lon, hgt])))
            if len(rows) >= max_points:
                break
    return np.array(rows, dtype=np.float64).reshape(-1, 3)
