"""Closed-loop DLL/PLL tracking, every channel in lockstep, one ms at a time.

Classic scalar GPS tracking (early/prompt/late correlators, normalized
envelope DLL, Costas PLL with carrier-aided code NCO): the per-millisecond
update is one function of a small state of [C] tensors, with the channels
as dim 0 of every [C, S] operand, and a Python loop over milliseconds
writes each step's outputs into [n_ms, C] tensors preallocated on the
device. Nothing in the loop reads a value back to the host, so the device
runs ahead of Python; one copy at the end brings the result back.

Precision: absolute code phase is kept as (int32 chip index mod 1023,
f32 fractional chip), so no f64 is needed on the device; the closed loop
absorbs the f32 NCO rounding (~1e-7 chip/ms) that an open-loop replica
would accumulate over long runs. The arithmetic is the JAX package's,
operation for operation in float32, with every divisor a device tensor
(a CUDA division by a host scalar multiplies by its reciprocal instead).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.constants import CA_SEQ_LEN, CODE_FREQ
from gps_sdr_sim_tpu_torch.models.cacode import all_codes
from gps_sdr_sim_tpu_torch.receiver.acquire import AcqResult

_EL_SPACING = 0.5  # early/late offset, chips


def _loop_gains(bw: float, T: float, zeta: float = 0.7071):
    """(Ki, Kp) of the PI loop filter: f = basis + Kp*e + Ki*sum(e).

    Standard 2nd-order loop (Kaplan & Hegarty): natural frequency
    w0 = 8*zeta*bw / (4*zeta^2 + 1), Kp = 2*zeta*w0, Ki = w0^2 * T.
    """
    w0 = bw * 8.0 * zeta / (4.0 * zeta * zeta + 1.0)
    return w0 * w0 * T, 2.0 * zeta * w0


@dataclass
class TrackResult:
    prns: np.ndarray        # [C]
    prompt: np.ndarray      # [n_ms, C] complex64 prompt correlator
    doppler: np.ndarray     # [n_ms, C] f32 carrier Doppler estimate (Hz)
    code_phase: np.ndarray  # [n_ms, C] f32 chip index at block start


def track_loop(x_re: torch.Tensor, x_im: torch.Tensor, ca: torch.Tensor,
               state0, fs: float, pll_bw: float = 18.0,
               dll_bw: float = 2.0) -> torch.Tensor:
    """Run the loops over every ms of x on x_re's device.

    x_re, x_im [n_ms, S] f32; ca [C, 1023] f32 in {-1,+1}; state0 =
    (chip_i int32, chip_f, carr_ph, f_wipe, i_pll, d_nco, i_dll), each [C]
    (f32 unless named); f_wipe's start value is also the carrier basis.
    Returns [4, n_ms, C] f32 on the device: prompt re, prompt im, Doppler
    and code phase, each at block start.
    """
    dev = x_re.device
    n_ms, s = x_re.shape
    T = 1e-3
    ki_p, kp_p = _loop_gains(pll_bw, T)
    ki_d, kp_d = _loop_gains(dll_bw, T)

    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    fs_t, c1540, two_pi = const(fs), const(1540.0), const(2.0 * math.pi)
    k = torch.arange(s, dtype=torch.float32, device=dev)
    # Early, prompt, late offsets (chips), one per row of a [3, C, S] stack.
    offsets = const([_EL_SPACING, 0.0, -_EL_SPACING])[:, None, None]
    ca3 = ca[None].expand(3, -1, -1)
    chip_i, chip_f, carr_ph, f_wipe, i_pll, d_nco, i_dll = state0
    f_basis = f_wipe
    out = torch.empty((4, n_ms, ca.shape[0]), dtype=torch.float32,
                      device=dev)

    for m in range(n_ms):
        f_code = CODE_FREQ + f_wipe / c1540 + d_nco  # carrier-aided
        code_step = f_code / fs_t
        cp = chip_f[:, None] + k * code_step[:, None]  # [C, S]

        # floor, then the int32 floor-mod: the JAX package's chip index.
        j = torch.remainder(
            chip_i[:, None] + torch.floor(cp + offsets).to(torch.int32),
            CA_SEQ_LEN)
        code = torch.gather(ca3, 2, j.long())  # [3, C, S]

        phase = (2.0 * math.pi) * (carr_ph[:, None]
                                   + k * (f_wipe / fs_t)[:, None])
        c, sn = torch.cos(phase), torch.sin(phase)
        # y = x * e^{-j phase}
        y_re = x_re[m] * c + x_im[m] * sn
        y_im = x_im[m] * c - x_re[m] * sn
        c_re = (y_re * code).sum(dim=2)  # [3, C]: early, prompt, late
        c_im = (y_im * code).sum(dim=2)
        p_re, p_im = c_re[1], c_im[1]

        # Costas discriminator (cycles), insensitive to nav-bit sign.
        e_pll = torch.arctan(p_im / (p_re + 1e-12)) / two_pi
        # Normalized non-coherent early-late envelope (chips).
        ae = torch.sqrt(c_re[0] * c_re[0] + c_im[0] * c_im[0])
        al = torch.sqrt(c_re[2] * c_re[2] + c_im[2] * c_im[2])
        e_dll = 0.5 * (ae - al) / (ae + al + 1e-12)

        i_pll = i_pll + e_pll
        f_wipe_next = f_basis + kp_p * e_pll + ki_p * i_pll
        i_dll = i_dll + e_dll
        d_nco_next = kp_d * e_dll + ki_d * i_dll

        # Output carries BLOCK-START state (phase before this block's
        # advance) — pvt.transmit_time depends on that convention.
        out[0, m] = p_re
        out[1, m] = p_im
        out[2, m] = f_wipe
        out[3, m] = chip_i.to(torch.float32) + chip_f

        # Advance NCOs with the frequencies actually used this block.
        carr_ph = torch.remainder(carr_ph + s * (f_wipe / fs_t), 1.0)
        total = chip_f + s * code_step
        adv = torch.floor(total).to(torch.int32)
        chip_f = total - adv.to(torch.float32)
        chip_i = torch.remainder(chip_i + adv, CA_SEQ_LEN)
        f_wipe, d_nco = f_wipe_next, d_nco_next
    return out


def track(x: np.ndarray, fs: float, acq: Sequence[AcqResult],
          pll_bw: float = 18.0, dll_bw: float = 2.0,
          device="cuda") -> TrackResult:
    """Track acquired channels through baseband samples x (complex64) on
    `device`."""
    acq = [a for a in acq if a.detected]
    if not acq:
        raise ValueError("no detected channels to track")
    s = int(round(fs * 1e-3))
    n_ms = len(x) // s
    C = len(acq)

    codes = all_codes().astype(np.float32) * 2 - 1  # [32, 1023] {-1,+1}
    ca = np.stack([codes[a.prn - 1] for a in acq])

    # Acquisition reports the sample offset where the code period starts;
    # convert to chips elapsed since the code start at sample 0.
    chip0 = np.array(
        [(-a.code_phase * CODE_FREQ / fs) % CA_SEQ_LEN for a in acq],
        np.float64)
    chip_i = chip0.astype(np.int32)
    chip_f = (chip0 - chip_i).astype(np.float32)
    f0 = np.array([a.doppler for a in acq], np.float32)

    zeros = np.zeros(C, np.float32)
    x_blocks = np.asarray(x[:n_ms * s], np.complex64).reshape(n_ms, s)
    x_re = np.ascontiguousarray(x_blocks.real, np.float32)
    x_im = np.ascontiguousarray(x_blocks.imag, np.float32)
    device = torch.device(device)
    state0 = tuple(torch.from_numpy(a).to(device) for a in
                   (chip_i, chip_f, zeros, f0, zeros, zeros, zeros))
    threads = torch.get_num_threads()
    if device.type == "cpu":
        # Each step's ops are small ([3, C, S]): intra-op threads gain
        # little on idle cores, but when other processes share the cores
        # every op waits for its slowest thread and the loop stalls for
        # minutes where it takes seconds alone, so it runs on one.
        torch.set_num_threads(1)
    try:
        p_re, p_im, dop, cph = track_loop(
            torch.from_numpy(x_re).to(device),
            torch.from_numpy(x_im).to(device),
            torch.from_numpy(ca).to(device), state0, fs, pll_bw,
            dll_bw).cpu().numpy()
    finally:
        torch.set_num_threads(threads)

    return TrackResult(
        prns=np.array([a.prn for a in acq], np.int32),
        prompt=(p_re + 1j * p_im).astype(np.complex64),
        doppler=dop, code_phase=cph)
