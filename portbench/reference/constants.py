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

# The port's sub-block (its constants.SUBBLOCK at its default): phase
# ramps are rebased exactly every SUBBLOCK samples, and the output bytes
# depend on where. Fixed here: the reference reads no environment.
SUBBLOCK = 2048
PHASE_FRAC_BITS = 40  # fixed-point resolution of the in-kernel phase ramp
