"""C/A (Gold) code generation for GPS PRN 1..32.

Parity target: codegen (gpssim.c:132-171). Two 10-stage LFSRs (G1, G2) in
{-1,+1} arithmetic; the per-PRN G2 delay table selects the code phase offset.
Output chips are in {0, 1} like the reference; callers convert to +/-1.

TPU-first note: codes are generated once per scenario on the host (32 x 1023
ints) and shipped to the device as a lookup table; there is nothing to
accelerate here.
"""

from __future__ import annotations

import numpy as np

from gps_sdr_sim_tpu_torch.constants import CA_SEQ_LEN

# G2 delay per PRN (gpssim.c:134-138)
G2_DELAY = [
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
]


def codegen(prn: int) -> np.ndarray:
    """Generate the 1023-chip C/A code for a PRN in 1..32, chips in {0,1}."""
    if prn < 1 or prn > 32:
        raise ValueError(f"PRN must be in 1..32, got {prn}")

    r1 = [-1] * 10
    r2 = [-1] * 10
    g1 = np.empty(CA_SEQ_LEN, dtype=np.int64)
    g2 = np.empty(CA_SEQ_LEN, dtype=np.int64)

    for i in range(CA_SEQ_LEN):
        g1[i] = r1[9]
        g2[i] = r2[9]
        c1 = r1[2] * r1[9]
        c2 = r2[1] * r2[2] * r2[5] * r2[7] * r2[8] * r2[9]
        r1 = [c1] + r1[:9]
        r2 = [c2] + r2[:9]

    delay = G2_DELAY[prn - 1]
    j = (np.arange(CA_SEQ_LEN) + CA_SEQ_LEN - delay) % CA_SEQ_LEN
    ca = (1 - g1 * g2[j]) // 2
    return ca.astype(np.int32)


def all_codes() -> np.ndarray:
    """All 32 PRN codes as a [32, 1023] int32 array of {0,1} chips."""
    return np.stack([codegen(prn) for prn in range(1, 33)])
