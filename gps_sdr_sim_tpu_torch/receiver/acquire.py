"""FFT parallel code-phase search (PCPS) acquisition.

For each PRN and Doppler bin, one circular correlation over a 1 ms code
period via FFTs:

    R = ifft( fft(x_ms * e^{-j2pi f_d t}) * conj(fft(ca_fs)) )

evaluated for all code phases at once. PRNs and Doppler bins are the two
leading dims of one [n_prn, n_dopp, S] torch.fft program on the chosen
device; no Python loop runs over the grid.

Non-coherent integration over `n_blocks` consecutive milliseconds rides out
nav-bit sign flips.

The host side (AcqResult, sampled_codes, search_prep, assemble_results,
_fine_doppler) is the JAX package's, unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.constants import CA_SEQ_LEN, CODE_FREQ
from gps_sdr_sim_tpu_torch.models.cacode import all_codes


@dataclass
class AcqResult:
    prn: int
    doppler: float        # Hz
    code_phase: float     # samples into the code period
    metric: float         # peak / noise-floor ratio
    detected: bool


def sampled_codes(fs: float) -> np.ndarray:
    """[32, S] C/A codes in {-1,+1} resampled to fs (S = one 1 ms period)."""
    s = int(round(fs * 1e-3))
    chips = (np.arange(s) * (CODE_FREQ / fs)).astype(np.int64) % CA_SEQ_LEN
    codes = all_codes().astype(np.int8)  # [32, 1023] in {0,1}
    return (codes[:, chips] * 2 - 1).astype(np.float32)


def search(x_blocks: torch.Tensor, code_fft: torch.Tensor,
           dopp_hz: torch.Tensor, fs: float):
    """Non-coherent FFT search on x_blocks' device.

    x_blocks [B, S] complex64, code_fft [P, S] complex64, dopp_hz [D] f32.
    Returns (peak [P] f32, flat argmax [P] int64 into D*S, mean [P] f32) of
    the [P, D, S] power cube, still on the device.
    """
    s = x_blocks.shape[1]
    t = torch.arange(s, dtype=torch.float32, device=x_blocks.device) / \
        torch.tensor(fs, dtype=torch.float32, device=x_blocks.device)
    phase = (dopp_hz[:, None] * (-2.0 * math.pi)) * t[None, :]
    carr = torch.polar(torch.ones_like(phase), phase)  # [D, S]
    code_conj = code_fft.conj()[:, None, :]

    # Accumulate non-coherent power block by block: peak memory is one
    # [P, D, S] correlation cube instead of [P, D, B, S].
    power = torch.zeros((code_fft.shape[0], dopp_hz.shape[0], s),
                        dtype=torch.float32, device=x_blocks.device)
    for b in range(x_blocks.shape[0]):
        xf = torch.fft.fft(x_blocks[b][None, :] * carr, dim=-1)  # [D, S]
        corr = torch.fft.ifft(xf[None] * code_conj, dim=-1)
        power += corr.abs().square_()
    flat = power.reshape(power.shape[0], -1)
    return flat.amax(dim=1), flat.argmax(dim=1), flat.mean(dim=1)


def _fine_doppler(x: np.ndarray, fs: float, code: np.ndarray,
                  code_phase: int, coarse: float, n_ms: int = 16) -> float:
    """Refine Doppler: FFT of the code-wiped 1 ms correlation series.

    With the code aligned at the coarse peak, the prompt correlations over
    n_ms milliseconds are a pure tone at the residual carrier; a
    zero-padded FFT locates it to ~1000/n_ms/8 Hz. Nav-bit sign flips only
    add a conjugate-symmetric image, which the |.| peak ignores.
    """
    s = len(code)
    n_ms = min(n_ms, (len(x) - code_phase) // s)
    if n_ms < 2:
        return coarse  # not enough signal past the peak to refine
    t = np.arange(n_ms * s, dtype=np.float64) / fs
    seg = x[code_phase:code_phase + n_ms * s] * np.exp(-2j * np.pi * coarse * t)
    p = (seg.reshape(n_ms, s) * code[None, :]).sum(axis=1)
    nfft = 8 * n_ms
    spec = np.abs(np.fft.fft(p * p, nfft))  # squaring removes bit flips
    f = np.fft.fftfreq(nfft, d=1e-3)
    return coarse + float(f[int(np.argmax(spec))]) / 2.0


def search_prep(x: np.ndarray, fs: float, prns: Optional[Sequence[int]],
                dopp_max: float, dopp_step: float, n_blocks: int):
    """Shared search setup: PRN list, 1 ms size, Doppler grid, ms blocks."""
    if prns is None:
        prns = range(1, 33)
    prns = list(prns)
    s = int(round(fs * 1e-3))
    if len(x) < n_blocks * s:
        raise ValueError(f"need {n_blocks} ms of samples, got {len(x)/s:.2f}")
    codes = sampled_codes(fs)[[p - 1 for p in prns]]
    dopp = np.arange(-dopp_max, dopp_max + dopp_step / 2, dopp_step,
                     dtype=np.float32)
    xb = np.asarray(x[:n_blocks * s], np.complex64).reshape(n_blocks, s)
    return prns, s, codes, dopp, xb


def assemble_results(x, fs, prns, codes, s, dopp, peak, arg, mean,
                     threshold: float, fine: bool) -> List[AcqResult]:
    """Shared detection contract: peak/arg/mean per PRN -> AcqResults."""
    out = []
    for i, prn in enumerate(prns):
        d_idx, c_idx = divmod(int(arg[i]), s)
        metric = float(peak[i] / mean[i])
        detected = metric > threshold
        fd = float(dopp[d_idx])
        if detected and fine:
            fd = _fine_doppler(np.asarray(x, np.complex64), fs,
                               codes[i].astype(np.float32), c_idx, fd)
        out.append(AcqResult(
            prn=prn, doppler=fd, code_phase=float(c_idx),
            metric=metric, detected=detected))
    return out


def acquire(x: np.ndarray, fs: float,
            prns: Optional[Sequence[int]] = None,
            dopp_max: float = 5000.0, dopp_step: float = 250.0,
            n_blocks: int = 4, threshold: float = 12.0,
            fine: bool = True, device="cuda") -> List[AcqResult]:
    """Search `prns` (default 1..32) in baseband samples x (>= n_blocks ms)
    on `device`."""
    prns, s, codes, dopp, xb = search_prep(x, fs, prns, dopp_max, dopp_step,
                                           n_blocks)
    code_fft = np.fft.fft(codes, axis=-1).astype(np.complex64)

    device = torch.device(device)
    peak, arg, mean = search(
        torch.from_numpy(xb).to(device), torch.from_numpy(code_fft).to(device),
        torch.from_numpy(dopp).to(device), fs)
    peak, arg, mean = (a.cpu().numpy() for a in (peak, arg, mean))

    return assemble_results(x, fs, prns, codes, s, dopp, peak, arg, mean,
                            threshold, fine)
