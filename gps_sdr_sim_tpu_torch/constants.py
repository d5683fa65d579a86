"""GPS / simulator constants.

Mirrors the constant set of the reference simulator (gpssim.h:1-81) so host
math reproduces the C oracle bit-for-bit where possible.
"""

# Capacity limits (gpssim.h:10-24)
MAX_CHAR = 100
MAX_SAT = 32
MAX_CHAN = 16
USER_MOTION_SIZE = 3000  # max dynamic-mode points at 10 Hz (runtime-settable here)
STATIC_MAX_DURATION = 86400  # seconds

# Navigation message framing (gpssim.h:26-33)
N_SBF = 5
N_DWRD_SBF = 10
N_DWRD = (N_SBF + 1) * N_DWRD_SBF  # 60-word buffer: carried subframe 5 + 5 fresh

# C/A code (gpssim.h:35-36)
CA_SEQ_LEN = 1023

# Time (gpssim.h:38-42)
SECONDS_IN_WEEK = 604800.0
SECONDS_IN_HALF_WEEK = 302400.0
SECONDS_IN_DAY = 86400.0
SECONDS_IN_HOUR = 3600.0
SECONDS_IN_MINUTE = 60.0

# Powers of two used by the ICD-GPS-200 nav-message scaling (gpssim.h:44-55)
POW2_M5 = 0.03125
POW2_M19 = 1.907348632812500e-6
POW2_M29 = 1.862645149230957e-9
POW2_M31 = 4.656612873077393e-10
POW2_M33 = 1.164153218269348e-10
POW2_M43 = 1.136868377216160e-13
POW2_M55 = 2.775557561562891e-17
POW2_M50 = 8.881784197001252e-016
POW2_M30 = 9.313225746154785e-010
POW2_M27 = 7.450580596923828e-009
POW2_M24 = 5.960464477539063e-008

# Conventional WGS84/ICD values (gpssim.h:57-68)
GM_EARTH = 3.986005e14
OMEGA_EARTH = 7.2921151467e-5
PI = 3.1415926535898  # NOTE: the reference uses this truncated value, not math.pi
WGS84_RADIUS = 6378137.0
WGS84_ECCENTRICITY = 0.0818191908426
R2D = 57.2957795131
SPEED_OF_LIGHT = 2.99792458e8
LAMBDA_L1 = 0.190293672798365

# Signal structure (gpssim.h:70-74)
CARR_FREQ = 1575.42e6
CODE_FREQ = 1.023e6
CARR_TO_CODE = 1.0 / 1540.0

# Output sample formats (gpssim.h:76-79)
SC01 = 1
SC08 = 8
SC16 = 16

# Daily broadcast-ephemeris file capacity (gpssim.h:81)
EPHEM_ARRAY_SIZE = 13

# Kernel decomposition parameters (TPU-native; not in the reference).
# Sub-block length in samples: phase ramps are rebased (exact integer
# accumulation of the 2^56 step) every SUBBLOCK samples so the in-kernel
# 40-bit fixed-point closed form (three 16-bit limbs in int32 arithmetic)
# never overflows. The env override is a perf-tuning knob; measured on the
# target chip (interleaved best-of-3 ablation, 2026-08-17): 2048 -> ~506x,
# 4096 -> ~433x realtime (8192 hangs Mosaic compilation), so 2048 is the
# tuned default. The xla and pallas paths stay bit-identical to EACH OTHER
# at any value; different values may flip isolated razor-edge samples
# (~2^-43 phase difference from the per-sub-block truncation point) within
# the oracle budget.
import os as _os

SUBBLOCK = int(_os.environ.get("GPS_SDR_SIM_SUBBLOCK", "2048"))
if not (0 < SUBBLOCK <= 4096 and SUBBLOCK % 128 == 0):
    raise ValueError("GPS_SDR_SIM_SUBBLOCK must be a positive multiple of "
                     "128, at most 4096 (8192 hangs Mosaic compilation)")
PHASE_FRAC_BITS = 40  # fixed-point resolution of the in-kernel phase ramp
