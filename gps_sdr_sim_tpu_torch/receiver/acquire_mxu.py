"""Acquisition as int8 circulant matrix products.

The port of gps_sdr_sim_tpu.receiver.acquire_mxu. The code-phase search

    corr[d, tau] = sum_k wipe(x, f_d)[k] * code[(k - tau) mod S]

is one [n_dopp*n_blocks*2, S] @ [S, S] product per PRN: the carrier-wiped
re/im rows of the signal against the circulant matrix of the code replica.
The wiped signal is max-normalized into int8 (the code is +-1 exactly, and
acquisition needs correlation gain, not per-sample precision), so each
product is int8 x int8 with int32 sums: torch._int_mm, which on the card is
cuBLASLt's int8 tensor-core GEMM and on the CPU the host's int8 GEMM. The
JAX package leaves the product to XLA's dot_general; no Pallas kernel is on
this path, and none is here.

torch._int_mm on CUDA takes more than 16 rows and inner and output widths
that are multiples of 8. The operands are padded with zeros to such a shape
on every device (zeros add nothing to the int32 sums), and the product is
sliced back; at 2.048 Msps with the default grid (S = 2048, 1608 rows) no
padding is needed.

Same detection contract as acquire.py (search_prep, assemble_results): the
results are interchangeable with the FFT search's.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.receiver.acquire import (AcqResult,
                                                    assemble_results,
                                                    search_prep)

# torch._int_mm's shape rule on CUDA: more than 16 rows; inner and output
# widths multiples of 8.
_MIN_ROWS = 17
_ALIGN = 8


def padded_shape(rows: int, s: int) -> tuple[int, int]:
    """(rows, width) of the int8 product's operands after zero padding:
    at least _MIN_ROWS rows, a width that is a multiple of _ALIGN."""
    return max(rows, _MIN_ROWS), -(-s // _ALIGN) * _ALIGN


def circulant_index(s: int, device) -> torch.Tensor:
    """The shared circulant index, zero-padded: [n, n] int64 with
    idx[tau, k] = (k - tau) mod s for tau, k < s and s (the position of a
    zero appended to the code) in the padding, n = padded_shape's width."""
    n = padded_shape(0, s)[1]
    k = torch.arange(n, device=device)
    idx = torch.remainder(k[None, :] - k[:, None], s)
    idx[s:, :] = s
    idx[:, s:] = s
    return idx


def circulant(code8: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """circ[tau, k] = code8[(k - tau) mod S], [n, n] int8, zero in the
    padding of circulant_index's idx."""
    return torch.nn.functional.pad(code8, (0, 1))[idx]


def int_mm_padded(a8: torch.Tensor, circ: torch.Tensor) -> torch.Tensor:
    """a8 [M, S] int8 @ circ[:S, :S].T as int32 [M, S], through
    torch._int_mm on zero-padded operands. circ is a padded circulant
    [n, n] int8 (zero beyond row and column S), passed transposed: the
    column-major operand cuBLASLt's int8 GEMM takes."""
    m, s = a8.shape
    rows, n = padded_shape(m, s)
    if circ.shape != (n, n):
        raise ValueError(f"circulant {tuple(circ.shape)} != ({n}, {n})")
    if (rows, n) != (m, s):
        a8 = torch.nn.functional.pad(a8, (0, n - s, 0, rows - m))
    return torch._int_mm(a8, circ.t())[:m, :s]


def wipe_int8(x_re: torch.Tensor, x_im: torch.Tensor, dopp_hz: torch.Tensor,
              fs: float) -> torch.Tensor:
    """The blocks x [B, S] wiped by each Doppler bin's carrier,
    x * e^{-j 2 pi f t}, as re/im rows [D*B*2, S] int8 under one global
    scale 127 / max|w| (acquisition needs correlation gain across S
    samples, not per-sample precision)."""
    dev = x_re.device
    s = x_re.shape[1]
    t = torch.arange(s, dtype=torch.float32, device=dev) / \
        torch.tensor(fs, dtype=torch.float32, device=dev)
    ang = 2.0 * math.pi * dopp_hz[:, None] * t[None, :]
    c, sn = torch.cos(ang), torch.sin(ang)
    w_re = x_re[None] * c[:, None, :] + x_im[None] * sn[:, None, :]
    w_im = x_im[None] * c[:, None, :] - x_re[None] * sn[:, None, :]
    w = torch.stack([w_re, w_im], dim=2)  # [D, B, 2, S]
    scale = 127.0 / (w.abs().amax() + 1e-9)
    w8 = torch.clamp(torch.round(w * scale), -127, 127).to(torch.int8)
    return w8.reshape(-1, s)


def search_mxu(x_re: torch.Tensor, x_im: torch.Tensor, codes8: torch.Tensor,
               dopp_hz: torch.Tensor, fs: float):
    """Non-coherent int8 circulant search on the inputs' device.

    x_re, x_im [B, S] f32 (the ms blocks), codes8 [P, S] int8 in {-1, +1},
    dopp_hz [D] f32. Returns (peak [P] f32, flat argmax [P] int64 into D*S,
    mean [P] f32) of each PRN's [D, S] power, still on the device. One PRN
    at a time, so peak memory is one [D*B*2, S] int32 product.
    """
    n_blocks, s = x_re.shape
    w8 = wipe_int8(x_re, x_im, dopp_hz, fs)
    idx = circulant_index(s, x_re.device)
    peak, arg, mean = [], [], []
    for code in codes8:
        corr = int_mm_padded(w8, circulant(code, idx)).to(torch.float32)
        corr = corr.reshape(-1, n_blocks, 2, s)
        power = (corr[:, :, 0].square() + corr[:, :, 1].square()).sum(dim=1)
        flat = power.reshape(-1)
        peak.append(flat.amax())
        arg.append(flat.argmax())
        mean.append(flat.mean())
    return torch.stack(peak), torch.stack(arg), torch.stack(mean)


def search_inputs(xb: np.ndarray, codes: np.ndarray, dopp: np.ndarray,
                  device) -> tuple:
    """search_prep's blocks, codes and Doppler grid as search_mxu's
    (x_re, x_im, codes8, dopp_hz) on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in
                 (xb.real, xb.imag, codes.astype(np.int8), dopp))


def acquire_mxu(x: np.ndarray, fs: float,
                prns: Optional[Sequence[int]] = None,
                dopp_max: float = 5000.0, dopp_step: float = 250.0,
                n_blocks: int = 4, threshold: float = 12.0,
                fine: bool = True, device="cuda") -> List[AcqResult]:
    """acquire() through the int8 circulant search, on `device`."""
    prns, s, codes, dopp, xb = search_prep(x, fs, prns, dopp_max, dopp_step,
                                           n_blocks)
    codes8 = codes.astype(np.int8)

    peak, arg, mean = search_mxu(*search_inputs(xb, codes8, dopp, device),
                                 fs)
    peak, arg, mean = (a.cpu().numpy() for a in (peak, arg, mean))

    return assemble_results(x, fs, prns, codes8, s, dopp, peak, arg, mean,
                            threshold, fine)
