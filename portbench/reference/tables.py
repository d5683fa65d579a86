"""Quantized trig lookup tables used by the IQ mixer.

Parity target: sinTable512/cosTable512 (gpssim.c:15-83): 512-entry tables of
round(250*sin(2*pi*(i+0.5)/512)), except four entries that sit exactly on a
rounding boundary (value 105.50007) where the original table rounds *down*;
we apply those as explicit corrections. The cos table is exactly the sin
table rotated by 128 entries (verified against the reference binary).

Both device kernels recompute these values on the VPU from the closed-form
rule (gathers are slow on TPU); the _BOUNDARY_FIX entries become per-backend
baked corrections (synth_jnp._trig_corrections).
"""

from __future__ import annotations

import numpy as np

# Indices where round-half-away-from-zero disagrees with the reference table
# (the magnitude is 105.5000677; the reference rounds it to 105).
_BOUNDARY_FIX = (35, 220, 291, 476)


def _build_sin512() -> np.ndarray:
    i = np.arange(512)
    s = 250.0 * np.sin(2.0 * np.pi * (i + 0.5) / 512.0)
    t = (np.sign(s) * np.floor(np.abs(s) + 0.5)).astype(np.int32)
    for j in _BOUNDARY_FIX:
        t[j] -= np.sign(t[j]).astype(np.int32)
    return t


SIN_TABLE512 = _build_sin512()
COS_TABLE512 = SIN_TABLE512[(np.arange(512) + 128) % 512]

