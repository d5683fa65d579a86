"""The synthesis that the port's kernels compute, stated plainly.

For every output sample k of an epoch and every channel c with gain, in
exact int64 arithmetic (the port's fixed-point contract, ops/plan.py):

  phase at the start of k's sub-block: f + k0 * s, exact (k0 = k rounded
  down to a multiple of SUBBLOCK; f, s scaled by 2^56), kept as whole
  units and bits [16, 56);
  phase of k: that + (k - k0) * (s >> 16), in units of 2^-40;
  code chip count T (int32 wrap), period M = floor(T / 1023), chip
  T - 1023 M; C/A bit of the chip, nav bit of the 20 ms bit that holds
  period M (the walk of the 8-bit window, sign-filled outside it);
  carrier table index: bits [31, 40) of the carrier phase;
  I += gain * (+-1) * cos[index], Q += gain * (+-1) * sin[index].

Then each sum wraps to int32, (acc + 64) >> 7 wraps to int16 (gpssim.c
2192-2259). SC16 is the interleaved int16 (I, Q) pairs, SC08 each value
>> 4 as int8, SC01 the sign bits (value > 0) of I0 Q0 I1 Q1 ... packed
most significant bit first, a trailing partial byte dropped (gpssim.c
2266-2288).

`precision="float32"` is the control: the scenario's float64 Doppler and
phases (f_code, f_carr, code_phase0, carr_phase0) rounded to float32 before
planning, the step that computing the plan in float32 would take.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.constants import CA_SEQ_LEN, SUBBLOCK
from portbench.reference.plan import plan_epochs
from portbench.reference.tables import COS_TABLE512, SIN_TABLE512

_MASK40 = (1 << 40) - 1
PRECISIONS = ("float64", "float32")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


def _at_sample(f: torch.Tensor, s: torch.Tensor, k0: torch.Tensor,
               r: torch.Tensor):
    """Phase f + k * s (2^56 scale) at samples k = k0 + r: (whole units at
    the sub-block start, phase in units of 2^-40 from there). The 16/40-bit
    split keeps k0 * s below 2^63."""
    lo = (f & 0xFFFF) + k0 * (s & 0xFFFF)
    hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16)
    return hi >> 40, (hi & _MASK40) + r * (s >> 16)


def iq_epochs(eb, n_out: int, device) -> torch.Tensor:
    """EpochBatch (plan.plan_epochs) -> [B, n_out, 2] int16 SC16 samples
    on `device`."""
    def col(a, c):
        return torch.from_numpy(np.ascontiguousarray(a[:, c])).to(
            device=device, dtype=torch.int64)[:, None]

    k = torch.arange(n_out, device=device, dtype=torch.int64)[None]
    r = k % SUBBLOCK
    k0 = k - r
    cos = torch.from_numpy(COS_TABLE512.astype(np.int64)).to(device)
    sin = torch.from_numpy(SIN_TABLE512.astype(np.int64)).to(device)
    ca_words = torch.from_numpy(eb.ca_words.astype(np.int64)).to(device)
    B = eb.t0.shape[0]
    i_acc = torch.zeros((B, n_out), dtype=torch.int64, device=device)
    q_acc = torch.zeros_like(i_acc)
    for c in range(eb.n_chan):
        whole, code = _at_sample(col(eb.code_f, c), col(eb.code_s, c), k0, r)
        T = _wrap32(col(eb.t0, c) + whole + (code >> 40))
        M = torch.div(T, CA_SEQ_LEN, rounding_mode="floor")
        chip = T - CA_SEQ_LEN * M
        ca_bit = (ca_words[c][chip >> 5] >> (chip & 31)) & 1
        j = torch.div(col(eb.m0, c) - 20 * col(eb.b0, c) + M, 20,
                      rounding_mode="floor")
        navbits = col(eb.navbits, c)
        nav_bit = torch.where((j < 0) | (j > 31), navbits >> 31,
                              navbits >> j.clamp(0, 31)) & 1
        _, carr = _at_sample(col(eb.carr_f, c), col(eb.carr_s, c), k0, r)
        idx = (carr >> 31) & 0x1FF
        g = col(eb.gain, c) * (1 - 2 * (ca_bit ^ nav_bit))
        i_acc += g * cos[idx]
        q_acc += g * sin[idx]
    out = [_wrap16(_wrap32(_wrap32(a) + 64) >> 7) for a in (i_acc, q_acc)]
    return torch.stack(out, dim=-1).to(torch.int16)


def pack(iq: torch.Tensor, fmt: int) -> torch.Tensor:
    """[B, n, 2] int16 -> [B, bytes] uint8 of format `fmt` (16, 8 or 1)."""
    B, n, _ = iq.shape
    if fmt == 16:
        return iq.contiguous().view(torch.uint8).reshape(B, -1)
    if fmt == 8:
        return ((iq.to(torch.int32) >> 4) & 0xFF).to(torch.uint8).reshape(
            B, -1)
    if fmt == 1:
        bits = (iq[:, :n // 4 * 4] > 0).reshape(B, -1, 8).to(torch.int32)
        weights = 1 << torch.arange(7, -1, -1, device=iq.device,
                                    dtype=torch.int32)
        return (bits * weights).sum(dim=-1).to(torch.uint8)
    raise ValueError(f"Invalid I/Q data format: {fmt}")


def rounded(seg, precision: str):
    """`seg` as computed at `precision`: itself at float64; at float32 (the
    control) with its Doppler and phases rounded to float32."""
    if precision == "float64":
        return seg
    if precision != "float32":
        raise ValueError(f"precision must be one of {PRECISIONS}")
    f32 = {name: getattr(seg, name).astype(np.float32).astype(np.float64)
           for name in ("f_code", "f_carr", "code_phase0", "carr_phase0")}
    return dataclasses.replace(seg, **f32)


def locate(scn, epoch: int):
    """(segment, segment-local index) of output epoch `epoch` (0-based)."""
    for seg in scn.segments:
        e = epoch - (seg.first_epoch - 1)
        if 0 <= e < seg.n_epochs:
            return seg, e
    raise IndexError(f"output epoch {epoch} outside the scenario's "
                     f"{scn.n_output_epochs}")


def epoch_bytes(scn, epoch: int, device, fmt: int = 16,
                precision: str = "float64") -> bytes:
    """The bytes of output epoch `epoch` (0-based) of `scn` in format
    `fmt`."""
    seg, e = locate(scn, epoch)
    eb = plan_epochs(rounded(seg, precision), e, e + 1, scn.delt)
    iq = iq_epochs(eb, scn.iq_buff_size, device)
    return pack(iq, fmt)[0].cpu().numpy().tobytes()
