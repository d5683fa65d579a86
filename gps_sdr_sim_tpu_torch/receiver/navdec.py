"""Nav-message recovery: bit sync, frame sync, IS-GPS-200 parity, decode.

Operates on the prompt-correlator stream produced by receiver/track.py.
Bit and frame structure per the encoder it validates against
(models/navmsg.py; reference gpssim.c:1467-1547, 693-756): 20 ms bits,
30-bit words with D29*/D30* parity chaining, 300-bit subframes led by the
0x8B preamble, TOW in every HOW, week number in subframe 1 word 3.

All host-side NumPy — the data is 50 bits per second per channel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from gps_sdr_sim_tpu_torch.models.navmsg import compute_checksum

_PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], np.int8)  # 0x8B, D1..D8


def bit_sync(prompt: np.ndarray) -> int:
    """Find the 20 ms bit boundary: offset in [0, 20) ms.

    Picks the alignment whose 20 ms windows have the most coherent sign
    (maximum sum of |window sum| of the prompt I arm).
    """
    ip = np.real(prompt)
    best, best_off = -1.0, 0
    for off in range(20):
        n = (len(ip) - off) // 20
        if n < 1:
            continue
        w = ip[off:off + n * 20].reshape(n, 20).sum(axis=1)
        m = float(np.abs(w).sum())
        if m > best:
            best, best_off = m, off
    return best_off


def decode_bits(prompt: np.ndarray, offset: int) -> np.ndarray:
    """20 ms coherent sums -> hard bits in {0, 1} (sign of the I arm).

    The Costas loop's 180-degree ambiguity means the whole stream may be
    inverted; frame_sync resolves that by trying both polarities.
    """
    ip = np.real(prompt)
    n = (len(ip) - offset) // 20
    w = ip[offset:offset + n * 20].reshape(n, 20).sum(axis=1)
    return (w > 0).astype(np.int8)


def parity_ok(word: int, d29s: int, d30s: int) -> bool:
    """Check one received 30-bit word against its parity bits."""
    d_raw = (word & 0x3FFFFFC0) ^ (0x3FFFFFC0 if d30s else 0)
    src = (d29s << 31) | (d30s << 30) | d_raw
    return compute_checksum(src, nib=False) == (word & 0x3FFFFFFF)


@dataclass
class Subframe:
    bit_index: int        # index of D1 of word 1 in the decoded bit stream
    sbf_id: int           # 1..5 from the HOW
    tow_sec: float        # seconds of week at the NEXT subframe boundary
    week: Optional[int]   # 10 LSBs of the week number (subframe 1 only)
    words: np.ndarray     # [10] uint32 parity-checked transmitted words
    bits: np.ndarray      # [300] int8 in {0,1}


def _words_at(bits: np.ndarray, p: int) -> Optional[np.ndarray]:
    """Assemble + parity-check the 10 words starting at bit p."""
    if p < 2 or p + 300 > len(bits):
        return None
    words = np.zeros(10, np.uint32)
    d29s = int(bits[p - 2])
    d30s = int(bits[p - 1])
    for w in range(10):
        chunk = bits[p + 30 * w:p + 30 * (w + 1)]
        word = 0
        for b in chunk:
            word = (word << 1) | int(b)
        if not parity_ok(word, d29s, d30s):
            return None
        words[w] = word
        d29s = (word >> 1) & 1
        d30s = word & 1
    return words


def frame_sync(bits: np.ndarray) -> List[Subframe]:
    """Locate parity-valid subframes in a hard-bit stream.

    Returns every 300-bit group whose 10 words all pass parity, starting at
    a preamble match (direct or inverted: the word carrying the preamble is
    itself inverted when the previous word's D30* is 1). GPS word parity and
    the D30* data de-inversion are both invariant under a global stream
    flip, so the Costas 180-degree ambiguity needs no resolution here — the
    parsed data comes out identical either way; only the raw `bits` field
    keeps the received polarity.
    """
    out: List[Subframe] = []
    for p in range(2, len(bits) - 300 + 1):
        w = bits[p:p + 8]
        if not (np.array_equal(w, _PREAMBLE)
                or np.array_equal(w, _PREAMBLE ^ 1)):
            continue
        words = _words_at(bits, p)
        if words is not None:
            out.append(_parse(words, bits[p:p + 300], p))
    return out


def _data(word: int, d30s: int) -> int:
    """Recover the 24 raw data bits (D30* inversion removed)."""
    return ((word & 0x3FFFFFC0) ^ (0x3FFFFFC0 if d30s else 0)) >> 6


def _parse(words: np.ndarray, bits: np.ndarray, p: int) -> Subframe:
    # Previous word's D30* for word 2 is word 1's LSB.
    how = _data(int(words[1]), int(words[0]) & 1)
    tow = (how >> 7) & 0x1FFFF          # D1..D17 of the HOW
    sbf_id = (how >> 2) & 0x7           # D20..D22
    week = None
    if sbf_id == 1:
        w3 = _data(int(words[2]), int(words[1]) & 1)
        week = (w3 >> 14) & 0x3FF       # D1..D10 of word 3
    return Subframe(bit_index=p, sbf_id=sbf_id, tow_sec=tow * 6.0,
                    week=week, words=words, bits=bits.astype(np.int8))


def cn0_estimate(prompt: np.ndarray, fs_code: float = 1000.0,
                 m: int = 20) -> float:
    """C/N0 (dB-Hz) via the narrowband/wideband power-ratio method.

    Standard NWPR estimator (Van Dierendonck): over blocks of m prompt
    samples, NBP = |sum P|^2 captures coherent power, WBP = sum |P|^2
    total power; mu = <NBP/WBP> relates to coherent SNR per 1/fs_code
    integration. Used for the receiver CLI's per-channel C/N0 column (the
    u-center screenshots' signal-level bars, SURVEY.md §4).
    """
    n = (len(prompt) // m) * m
    if n < m:
        return float("nan")
    p = prompt[:n].reshape(-1, m)
    wbp = np.sum(np.abs(p) ** 2, axis=1)
    nbp = np.abs(np.sum(p, axis=1)) ** 2
    mu = float(np.mean(nbp / np.maximum(wbp, 1e-30)))
    if mu <= 1.0 or mu >= m:
        return float("nan")
    snr = (mu - 1.0) / (m - mu)
    return 10.0 * np.log10(max(snr * fs_code, 1e-12))
