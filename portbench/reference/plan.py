"""Host -> device batch preparation: exact fixed-point phase-ramp params.

The reference's hot loop advances two float64 NCOs (code chips and carrier
cycles) one sample at a time (gpssim.c:2212-2252). TPUs have no float64, so
instead of iterating we evaluate the phase ramps in closed form with an
exact integer decomposition:

  phase(k0 + r) = (P + r*S) / 2^40   (r < SUBBLOCK)

where P (the sub-block base phase, accumulated in exact integer arithmetic
from the epoch-start phase and the 2^56-quantized step) and S (bits
[16, 64) of that same step) are split into three 16-bit limbs covering
fractional bits [16, 56). In-kernel arithmetic is pure int32: with
r < 2^11 and limbs < 2^16, every partial product stays under 2^27 and
every carry chain under 2^31. (The Pallas kernel re-windows the same
integers into two 20-bit limbs — its chain peaks at exactly INT32_MAX —
to spend one fewer add+carry per ramp; see synth_pallas.) Because both
kernel paths (plan_batch -> XLA, plan_epochs -> Pallas on-device rebase)
derive their limbs from the same single step quantization by exact
integer accumulation, their outputs are bit-identical on any one backend. Quantization effects vs the
true f64 ramp: step drift < 2^18 * 2^-57 ~ 1e-12 per epoch, plus an
unaccumulated < 2^-29 in-sub-block truncation -- both far below the C
oracle's own f64-NCO noise, so chip boundaries and table indices match
the oracle within the documented golden budget.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference.constants import (
    CA_SEQ_LEN,
    MAX_CHAN,
)
from portbench.reference.scenario import Segment
from portbench.reference.cstd import c_round

_SCALE56 = float(1 << 56)
_MASK56 = (1 << 56) - 1
_SCALE25 = float(1 << 25)


def _code_step56(f_code: np.ndarray, delt: float) -> np.ndarray:
    """Code step (chips/sample) quantized once at 2^56, int64.

    This single rounding is THE step both kernel paths consume: the
    per-sub-block rebase (host-side in plan_batch, on-device in
    plan_epochs/synth_pallas) accumulates all 56 fractional bits exactly,
    and the in-kernel per-sample ramp uses bits [16, 64) — dropping the
    low 16 bits costs < 2^11 * 2^-40 ~ 2^-29 chips within a sub-block,
    never accumulated. Identical integers on both paths => bit-identical
    kernels; step quantization drift over a whole epoch is < 2^18 * 2^-57
    ~ 1e-12 chips, far below the C oracle's own f64-NCO noise.
    """
    return np.rint(f_code * delt * _SCALE56).astype(np.int64)


def _carr_step56(f_carr: np.ndarray, delt: float, fixed: bool) -> np.ndarray:
    """Carrier step (cycles/sample) quantized at 2^56, in [0, 2^56), int64.

    float mode: the reference's f64 accumulate-and-wrap (gpssim.c:2244-2250)
    quantized at 2^56 (a step rounding up to exactly 2^56 is congruent to 0
    and wraps). fixed mode: the reference's 32-bit NCO (FLOAT_CARR_PHASE
    undefined) steps by round(2^25 * f_carr * delt) counts of 2^-25 cycles
    (gpssim.c:2175-2177); only the phase mod 2^25 reaches the 9-bit table
    index ((carr_phase >> 16) & 0x1ff, gpssim.c:2202), so the wrapping
    32-bit add reduces exactly to this mod-2^25 ramp, scaled by 2^31 into
    the 2^56 domain -- bit-exact vs the C NCO.
    """
    if fixed:
        s25 = c_round(f_carr * delt * _SCALE25).astype(np.int64) % (1 << 25)
        return s25 << 31
    step = np.mod(f_carr * delt, 1.0)
    return np.rint(step * _SCALE56).astype(np.int64) & _MASK56


def _limbs8(x: np.ndarray, n: int = 7) -> np.ndarray:
    """Split non-negative int64 values (< 2^(8n)) into n 8-bit limbs, int32.

    8-bit limbs let the *device* perform the per-sub-block rebase exactly:
    k0 < 2^18 times an 8-bit limb stays under 2^26 in int32. For n=8 the
    limbs are exactly the value's little-endian bytes, so a byte view
    replaces the 8-step shift/mask loop.
    """
    if n == 8:
        return np.ascontiguousarray(x.astype(np.int64, copy=False)) \
            .view(np.uint8).reshape(x.shape + (8,)).astype(np.int32)
    out = np.empty(x.shape + (n,), dtype=np.int32)
    for j in range(n):
        out[..., j] = ((x >> (8 * j)) & 0xFF).astype(np.int32)
    return out


def _pack_navbits(bits_pm1: np.ndarray, m0: np.ndarray):
    """(b0, navbits): the 8-bit nav window per (epoch, channel).

    Within one epoch the ms counter advances by at most ~103 wraps, so bit
    indices span [m0//20, (m0+103)//20] — at most 7 values; pack 8 bits
    starting at b0 into one int per (epoch, channel).
    """
    b0 = m0 // 20
    bit01 = (bits_pm1 + 1) // 2  # {-1,+1} -> {0,1}, [C, 1800]
    j = np.arange(8, dtype=np.int64)
    bidx = np.minimum(b0[..., None] + j, 1799)
    window = np.take_along_axis(
        np.broadcast_to(bit01[None], (m0.shape[0],) + bit01.shape),
        bidx, axis=2)
    navbits = np.sum(window.astype(np.int64) << j, axis=-1).astype(np.int32)
    return b0, navbits


def _pack_ca_words(ca_pm1: np.ndarray) -> np.ndarray:
    """[C, 1023] chips in {-1,+1} -> [C, 32] int32, bit k of word w =
    chip 32*w + k (the kernels' where-tree selects words, then bits)."""
    key = ca_pm1.tobytes()
    cached = _CA_WORDS_CACHE.get(key)
    if cached is not None:
        return cached
    chip01 = ((ca_pm1 + 1) // 2).astype(np.int64)
    padded = np.zeros((chip01.shape[0], 1024), dtype=np.int64)
    padded[:, :CA_SEQ_LEN] = chip01
    k = np.arange(32, dtype=np.int64)
    words = np.sum(padded.reshape(-1, 32, 32) << k, axis=-1)
    words = words.astype(np.uint32).view(np.int32)
    if len(_CA_WORDS_CACHE) > 64:
        _CA_WORDS_CACHE.clear()
    _CA_WORDS_CACHE[key] = words
    return words


_CA_WORDS_CACHE: dict = {}


@dataclass
class EpochBatch:
    """Compact per-epoch device inputs (the fast path).

    Unlike DeviceBatch, nothing here is expanded per sub-block: the device
    performs the exact per-sub-block rebase itself from 8-bit limbs (see
    synth_pallas._device_rebase), so the host->device transfer is ~40 int32
    per (epoch, channel) regardless of sample rate. Channels are compacted
    (active first, n_chan of them) so inactive channels cost nothing.

    Phases/steps are stored as the raw non-negative 2^56-scaled int64
    words; the 8-bit-limb form the device unpacks (and tests inspect) is
    exactly their little-endian byte view, exposed via the *_8 properties.
    """

    t0: np.ndarray  # [B, C] int32 floor(code_phase0), chips
    code_f: np.ndarray  # [B, C] int64 frac(code_phase0) * 2^56
    code_s: np.ndarray  # [B, C] int64 code step * 2^56 (incl. integer chips)
    carr_f: np.ndarray  # [B, C] int64 frac(carr_phase0) * 2^56
    carr_s: np.ndarray  # [B, C] int64 carrier step * 2^56, in [0, 2^56)
    m0: np.ndarray  # [B, C] int32
    b0: np.ndarray  # [B, C] int32
    navbits: np.ndarray  # [B, C] int32
    gain: np.ndarray  # [B, C] int32
    ca_words: np.ndarray  # [C, 32] int32 bit-packed chips
    n_chan: int

    @property
    def code_f8(self) -> np.ndarray:  # [B, C, 8] int32 8-bit limbs
        return _limbs8(self.code_f, 8)

    @property
    def code_s8(self) -> np.ndarray:
        return _limbs8(self.code_s, 8)

    @property
    def carr_f8(self) -> np.ndarray:
        return _limbs8(self.carr_f, 8)

    @property
    def carr_s8(self) -> np.ndarray:
        return _limbs8(self.carr_s, 8)


def plan_epochs(seg: Segment, e0: int, e1: int, delt: float,
                compact: bool = True) -> EpochBatch:
    """Prepare epochs [e0, e1) of `seg` in the compact per-epoch form."""
    if compact:
        order = np.argsort(~seg.active, kind="stable")  # active first
        n_chan = int(seg.active.sum())
    else:
        order = np.arange(MAX_CHAN)
        n_chan = MAX_CHAN

    f_code = seg.f_code[e0:e1][:, order]
    f_carr = seg.f_carr[e0:e1][:, order]
    code_phase0 = seg.code_phase0[e0:e1][:, order]
    carr_phase0 = seg.carr_phase0[e0:e1][:, order]
    m0 = seg.m0[e0:e1][:, order].astype(np.int64)
    gain = (seg.gain[e0:e1] * seg.active[None, :])[:, order].astype(np.int32)
    bits = seg.bits[order]
    ca = seg.ca[order]

    # Steps: the SAME single 2^56 quantization as plan_batch; the on-device
    # rebase accumulates all 56 fractional bits exactly, so the kernel
    # limbs match the XLA path bit-for-bit. The code step exceeds 1
    # chip/sample below ~1.023 Msps, so steps get 8 limbs (64 bits); phase
    # fractions are < 1 but padded to match.
    s_code = _code_step56(f_code, delt)
    s_carr = _carr_step56(f_carr, delt, seg.carr_fixed)

    t0f = np.floor(code_phase0)
    code_f = ((code_phase0 - t0f) * _SCALE56).astype(np.int64)
    carr_f = ((carr_phase0 - np.floor(carr_phase0)) * _SCALE56) \
        .astype(np.int64)

    b0, navbits = _pack_navbits(bits, m0)
    ca_words = _pack_ca_words(ca)

    return EpochBatch(
        t0=t0f.astype(np.int32), code_f=code_f, code_s=s_code,
        carr_f=carr_f, carr_s=s_carr, m0=m0.astype(np.int32),
        b0=b0.astype(np.int32), navbits=navbits, gain=gain,
        ca_words=ca_words, n_chan=n_chan)
