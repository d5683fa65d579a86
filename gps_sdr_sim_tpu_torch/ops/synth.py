"""Fused I/Q synthesis: the wrapper, its plain PyTorch version, and staging.

Counterpart of gps_sdr_sim_tpu/ops/synth_pallas.py on the single-chip
packed path. One call turns a batch of per-epoch wires (plan.pack_epoch_wire,
[B, C, 12] int32) into the final output words, [B, SB * SUBBLOCK / div]
int32, SB = ceil(n_out / SUBBLOCK): viewed as little-endian bytes, each
epoch's row is the SC16/SC08/SC01 file stream, and its first
packed_bytes(n_out, fmt) bytes are valid.

`synth_wire` is the kernel's wrapper: on a CUDA tensor it launches the
hand-written kernel (csrc/synth.cu, via ops/synth_cuda.py) or raises; on a
CPU tensor it runs `synth_wire_ref`. `synth_wire_ref` is the plain version,
on any device. `synth_wire_planes` and `synth_wire_raw` are the wrappers of
the kernel's two other output modes, the K1 variants of the sharded path
(parallel/shard.py): the int16 I and Q planes after (acc + 64) >> 7, and
the raw int32 channel sums before it, each [B, SB * SUBBLOCK]; their plain
versions are `synth_wire_planes_ref` and `synth_wire_raw_ref`. The
arithmetic, which all of them follow exactly, is spelled out at the top of
csrc/synth.cu; `_channel_contribution` in
gps_sdr_sim_tpu/ops/synth_jnp.py is the readable statement of what it
computes.

Every wrapper and plain version takes `nav_gather`: the Pallas kernel's
`tpe > 0` variant, which reads the nav sign of code period M from a
per-(epoch, channel) 128-entry mask table (`nav_masks`) at lane M & 127
instead of walking the nav window. It is opt-in, as in the JAX package:
the runner reads GPS_SDR_SIM_NAV_GATHER (`nav_gather_enabled()`) at the
start of each run and passes it down. On real plans the two agree; where
T = -1 (M = -1) the table's lane 127 stands in for the walk's sign-filled
shift, so on such wires the two may differ.

The kernel takes code steps below 2 chips per sample (MAX_CODE_STEP; the
CLI's 1 Msps floor gives ~1.02): a wire or rows bound for a card are
checked on the host as they go up (upload_wire, upload_rows), and the
plain versions on the CPU take any step. `schedule_sums` is the kernel's
schedule in plain torch, for the tests; with `ablate` it is also the plain
version of the ablated instantiations that the cost-attribution tools time
(csrc/synth_profile.cu; `schedule_words` packs its sums into words).
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from gps_sdr_sim_tpu_torch import spans
from gps_sdr_sim_tpu_torch.constants import CA_SEQ_LEN, MAX_CHAN, SUBBLOCK
from gps_sdr_sim_tpu_torch.ops.plan import WIRE_LANES, pack_epoch_wire
from gps_sdr_sim_tpu_torch.ops.synth_cuda import ABLATE_BITS
from gps_sdr_sim_tpu_torch.ops.tables import COS_TABLE512, SIN_TABLE512

# Samples per int32 output word: SC16 one I/Q pair, SC08 two, SC01 sixteen.
PACK_DIV = {16: 1, 8: 2, 1: 16}

_MASK40 = (1 << 40) - 1

# The kernel's schedule (csrc/synth.cu kThreads, kSamplesPerThread,
# kSignWords, kPeriods), mirrored by schedule_sums.
THREADS = 128
SAMPLES_PER_THREAD = SUBBLOCK // THREADS
SIGN_WORDS = 128
PERIODS = 6
# The kernel's domain: a sub-block spans fewer than SIGN_WORDS * 32 chips,
# which any code step below 2 chips per sample (2^57 on the wire's 2^56
# scale) keeps; the CLI's 1 Msps floor gives ~1.02.
MAX_CODE_STEP = 1 << 57
# The CLI's floor on the sample rate, shared by the tools that take
# --samp-freq (refuse_samp_freq): at it a code step is ~1.02 chips per
# sample, inside the kernel's domain.
MIN_SAMP_FREQ = 1.0e6


def refuse_samp_freq(samp_freq) -> str | None:
    """The error line for a --samp-freq below MIN_SAMP_FREQ, or None."""
    if samp_freq is not None and samp_freq < MIN_SAMP_FREQ:
        return (f"ERROR: --samp-freq must be at least {MIN_SAMP_FREQ:g} "
                f"(the CLI's floor).")
    return None

# Launches of the hand-written kernels, counted where the wrapper launches
# them: one key per output mode of the wire form, one per mode of its
# nav-gather variant, and one per mode of the row form.
launch_counts = {"synth_wire": 0, "synth_wire_planes": 0, "synth_wire_raw": 0,
                 "synth_wire_nav": 0, "synth_wire_planes_nav": 0,
                 "synth_wire_raw_nav": 0, "synth_rows_planes": 0,
                 "synth_rows_raw": 0}


def nav_gather_enabled() -> bool:
    """The opt-in switch of the nav mask-table variant, read at call time
    (as gps_sdr_sim_tpu/ops/synth_pallas.py:nav_gather_enabled does)."""
    return os.environ.get("GPS_SDR_SIM_NAV_GATHER", "0") == "1"


def packed_bytes(n_out: int, fmt: int) -> int:
    """Valid output bytes per epoch of n_out samples in format `fmt`.

    SC01 drops a trailing partial byte like the reference (loop bound
    iq_buff_size/4, gpssim.c:2268)."""
    return {16: n_out * 4, 8: n_out * 2, 1: n_out // 4}[fmt]


def words_per_epoch(n_out: int, fmt: int) -> int:
    return -(-n_out // SUBBLOCK) * SUBBLOCK // PACK_DIV[fmt]


_TABLE_CACHE: dict = {}
_CA_CACHE: dict = {}


def trig_table(device) -> torch.Tensor:
    """[2, 512] int32 sin/cos table (gpssim.c:15-83) on `device`, cached."""
    device = torch.device(device)
    t = _TABLE_CACHE.get(device)
    if t is None:
        t = _TABLE_CACHE[device] = torch.from_numpy(
            np.stack([SIN_TABLE512, COS_TABLE512]).astype(np.int32)).to(device)
    return t


def ca_device(ca_words: np.ndarray, device) -> torch.Tensor:
    """Per-segment C/A words are identical across a segment's batches:
    upload each table once per device."""
    device = torch.device(device)
    key = (ca_words.tobytes(), device)
    t = _CA_CACHE.get(key)
    if t is None:
        if len(_CA_CACHE) > 64:
            _CA_CACHE.clear()
        t = _CA_CACHE[key] = torch.from_numpy(
            np.ascontiguousarray(ca_words, dtype=np.int32)).to(device)
    return t


class Staged(NamedTuple):
    """One batch of epochs on the device: what the kernel reads."""
    wire: torch.Tensor      # [B, C, 12] int32
    ca_words: torch.Tensor  # [C, 32] int32
    n_chan: int             # active channels, compacted first


def stage_epochs(eb, device) -> Staged:
    """EpochBatch (ops.plan.plan_epochs) -> device tensors.

    The wire is plan.pack_epoch_wire's int32 view of little-endian int64
    phase words (plan._split2), so the host must be little-endian. A CUDA
    upload goes from pinned memory on the current stream without blocking
    the host."""
    if sys.byteorder != "little":
        raise RuntimeError("the epoch wire is a little-endian byte view")
    device = torch.device(device)
    with spans.span("plan.pack_epoch_wire"):
        wire = pack_epoch_wire(eb)
    with spans.span("synth.upload"):
        return Staged(upload_wire(wire, device),
                      ca_device(eb.ca_words, device), max(eb.n_chan, 1))


def upload(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor without blocking the host (from pinned
    memory for a card)."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def _lanes_i64(a: np.ndarray, lane: int) -> np.ndarray:
    """The int64 in lanes (lane, lane + 1) of an int32 wire or row array."""
    return np.ascontiguousarray(a[..., lane:lane + 2]).view(np.int64)[..., 0]


def check_code_steps(code_step: np.ndarray, gain: np.ndarray,
                     frac_bits: int = 56) -> None:
    """Raise ValueError if a channel with gain has a code step outside the
    kernel's domain, [0, MAX_CODE_STEP) on the wire's 2^56 scale (steps
    with `frac_bits` fraction bits: 56 on the wire, 40 in a row). Checked on
    the host before a wire or rows go up to a card, so the kernel never
    meets one (its prologue would trap)."""
    code_step = np.asarray(code_step)
    bad = (np.asarray(gain) != 0) & (
        (code_step < 0) | (code_step >= MAX_CODE_STEP >> (56 - frac_bits)))
    if bad.any():
        worst = float(np.abs(code_step[bad].astype(np.float64)).max())
        raise ValueError(
            f"code step {worst / 2.0**frac_bits:.4f} chips per sample is "
            f"outside the CUDA kernel's domain (below "
            f"{MAX_CODE_STEP / 2.0**56:g}); the CLI's 1 Msps floor gives "
            f"~1.02")


def upload_wire(wire: np.ndarray, device) -> torch.Tensor:
    """upload() of a [B, C, 12] wire (plan.pack_epoch_wire). Bound for a
    card, a wire with a channel outside the kernel's domain is refused
    first (check_code_steps); the plain version on the CPU takes any."""
    if torch.device(device).type == "cuda":
        check_code_steps(_lanes_i64(wire, 2), wire[..., 11])
    return upload(wire, device)


# ---------------------------------------------------------------------------
# The row form: one rebased parameter row per (epoch, sub-block, channel).
# ---------------------------------------------------------------------------

# Lanes of a row, the wire's positions with rebased values: 0-1 code_base
# and 4-5 carr_base (bits [16, 56) of the sub-block's phase, units 2^-40),
# 2-3 code_step and 6-7 carr_step (bits [16, 64) of the 2^56 step), each
# little-endian (low word first); 8 t_base (whole chips since the epoch
# start at the sub-block), 9 m0r (m0 - 20 * b0), 10 navbits, 11 gain.
ROW_LANES = 12


def upload_rows(rows: np.ndarray, device) -> torch.Tensor:
    """upload() of [B, SB, C, ROW_LANES] rows (pack_rows), refused first
    like upload_wire when bound for a card."""
    if torch.device(device).type == "cuda":
        check_code_steps(_lanes_i64(rows, 2), rows[..., 11], frac_bits=40)
    return upload(rows, device)


def _limbs_u64(limbs: np.ndarray) -> np.ndarray:
    """[..., 3] 16-bit limbs (plan._limbs) -> int64."""
    x = limbs.astype(np.int64)
    return x[..., 0] | (x[..., 1] << 16) | (x[..., 2] << 32)


def pack_rows(db) -> np.ndarray:
    """DeviceBatch (ops.plan.plan_batch) -> [B, SB, C, ROW_LANES] int32 rows.

    Counterpart of gps_sdr_sim_tpu/ops/synth_pallas.py:pack_params with the
    port's own layout: the same exact integers, whole instead of in 20-bit
    limbs; per-epoch fields repeat in every sub-block's row."""
    if sys.byteorder != "little":
        raise RuntimeError("the rows are a little-endian byte view")
    B, SB, C = db.t_base.shape
    rows = np.empty((B, SB, C, ROW_LANES), np.int32)

    def put64(lane, v):  # int64 broadcastable to [B, SB, C]
        v = np.ascontiguousarray(np.broadcast_to(v, (B, SB, C)))
        rows[..., lane:lane + 2] = v.view(np.int32).reshape(B, SB, C, 2)

    put64(0, _limbs_u64(db.code_p))
    put64(2, _limbs_u64(db.code_s)[:, None])
    put64(4, _limbs_u64(db.carr_p))
    put64(6, _limbs_u64(db.carr_s)[:, None])
    rows[..., 8] = db.t_base
    rows[..., 9] = (db.m0 - 20 * db.b0)[:, None]
    rows[..., 10] = db.navbits[:, None]
    rows[..., 11] = db.gain[:, None]
    return rows


# ---------------------------------------------------------------------------
# Plain PyTorch version. All arithmetic is int64 on exact integers; int32
# wrap-around is applied explicitly where the kernel wraps.
# ---------------------------------------------------------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


def floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    """floor(a / b): M and the nav bit index are floor divisions, and
    T = -1 is reachable (CUDA's `/` truncates toward zero instead)."""
    return torch.div(a, b, rounding_mode="floor")


def shr_signfill(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x >> s for int32-valued x, sign-filling when s < 0 or s > 31 (the
    XLA rule for out-of-range shift amounts; C++ leaves it undefined)."""
    out_of_range = (s < 0) | (s > 31)
    return torch.where(out_of_range, x >> 31, x >> s.clamp(0, 31))


def rebase(f: torch.Tensor, s: torch.Tensor, k0: torch.Tensor):
    """Exact f + k0 * s for 2^56-scaled f, s >= 0 and k0 < 2^21.

    The 16/40-bit split of plan.py keeps every term below 2^63 where the
    naive product reaches ~2^75 at 1 Msps. Returns (bits [16, 56) of the
    sum in units of 2^-40, bits >= 56 as whole units)."""
    lo = (f & 0xFFFF) + k0 * (s & 0xFFFF)
    hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16)
    return hi & _MASK40, hi >> 40


def _unpack(wire: torch.Tensor) -> dict:
    w = wire.to(torch.int64)

    def u64(lane):
        return (w[..., lane] & 0xFFFFFFFF) | (w[..., lane + 1] << 32)

    m0 = w[..., 9] & 0xFFFF
    b0 = w[..., 9] >> 16
    return dict(code_f=u64(0), code_s=u64(2), carr_f=u64(4), carr_s=u64(6),
                t0=w[..., 8], m0=m0, b0=b0, m0r=m0 - 20 * b0,
                navbits=w[..., 10], gain=w[..., 11])


def nav_masks(m0: torch.Tensor, b0: torch.Tensor,
              navbits: torch.Tensor) -> torch.Tensor:
    """[B, C] nav window fields -> [B*C, 128] int32 sign masks (0 / -1).

    Lane m holds -(nav bit of code period m0 + m): bit
    clip(floor((m0 + m) / 20) - b0, 0, 31) of the window, as
    gps_sdr_sim_tpu/ops/synth_pallas.py:nav_masks computes it. There the
    floor is floor((mg + 0.5) * float32(1/20)); the two agree for every
    mg = m0 + m in [-1, 2^17), and the wire's m0 has 16 bits."""
    m = torch.arange(128, device=m0.device, dtype=torch.int64)
    j = (floor_div(m0.long()[..., None] + m, 20)
         - b0.long()[..., None]).clamp(0, 31)
    mask = -((navbits.long()[..., None] >> j) & 1)
    return mask.reshape(-1, 128).to(torch.int32)


def nav_table_from_wire(wire: torch.Tensor) -> torch.Tensor:
    """[B, C, 12] wire -> [B*C, 128] nav masks (see nav_masks)."""
    u = _unpack(wire)
    return nav_masks(u["m0"], u["b0"], u["navbits"])


def _channel_sums(f: dict, ca_words, n_chan: int, masks=None):
    """Channel sums (I, Q) over the first n_chan channels, int64
    [B, SB, SUBBLOCK], before the int32 wrap, from the per-(epoch,
    sub-block, channel) parameters that the kernel's block prologue
    fills: int64 fields of shape [B, SB, C] or [B, 1, C] (code_base,
    carr_base: bits [16, 56) of the phase in units of 2^-40; code_step,
    carr_step: bits [16, 64) of the step; t_base, m0r, navbits, gain).
    masks: [B, C, 128] nav masks (the mask-table variant: the nav bit of
    code period M is lane M & 127, M = -1 reading lane 127), else the
    window walk."""
    dev = ca_words.device
    r = torch.arange(SUBBLOCK, device=dev, dtype=torch.int64)
    tbl = trig_table(dev).to(torch.int64)
    ca = ca_words.to(torch.int64)
    B, SB = f["code_base"].shape[:2]
    iacc = torch.zeros((B, SB, SUBBLOCK), dtype=torch.int64, device=dev)
    qacc = torch.zeros_like(iacc)
    for c in range(n_chan):
        def col(name):
            return f[name][:, :, c, None]            # [B, SB or 1, 1]

        T = _wrap32(col("t_base")
                    + ((col("code_base") + r * col("code_step")) >> 40))
        M = floor_div(T, CA_SEQ_LEN)
        chip = T - CA_SEQ_LEN * M
        ca_bit = (ca[c][chip >> 5] >> (chip & 31)) & 1
        if masks is not None:
            nav_bit = torch.gather(masks[:, c], 1, (M & 127).reshape(
                B, -1)).reshape(M.shape) & 1
        else:
            j = floor_div(col("m0r") + M, 20)
            nav_bit = shr_signfill(col("navbits"), j) & 1
        idx = ((col("carr_base") + r * col("carr_step")) >> 31) & 0x1FF
        sign = 1 - 2 * (ca_bit ^ nav_bit)
        g = col("gain") * sign
        iacc += g * tbl[1][idx]
        qacc += g * tbl[0][idx]
    return iacc, qacc


def _wire_fields(wire, sub_blocks: int) -> dict:
    """The per-(epoch, sub-block, channel) fields of _channel_sums, int64
    [B, SB, C] or [B, 1, C], from a [B, C, 12] wire: the exact rebase to
    each sub-block (csrc/synth.cu load_chan)."""
    u = {k: v[:, None, :] for k, v in _unpack(wire).items()}  # [B, 1, C]
    k0 = (torch.arange(sub_blocks, device=wire.device, dtype=torch.int64)
          * SUBBLOCK)[None, :, None]                 # [1, SB, 1]
    code_base, carry = rebase(u["code_f"], u["code_s"], k0)
    carr_base, _ = rebase(u["carr_f"], u["carr_s"], k0)
    return dict(code_base=code_base, code_step=u["code_s"] >> 16,
                carr_base=carr_base, carr_step=u["carr_s"] >> 16,
                t_base=u["t0"] + carry, m0r=u["m0r"], navbits=u["navbits"],
                gain=u["gain"])


def _wire_masks(wire, nav_gather: bool):
    """[B, C, 128] nav masks of a wire for the mask-table variant, else
    None (the window walk)."""
    if not nav_gather:
        return None
    return nav_table_from_wire(wire).reshape(
        wire.shape[0], wire.shape[1], 128).to(torch.int64)


def _accumulate_iq(wire, ca_words, n_chan: int, sub_blocks: int,
                   nav_gather: bool = False):
    """Channel sums (I, Q) over the first n_chan channels of a wire, int64
    [B, SB, SUBBLOCK], before the int32 wrap: the exact rebase to each
    sub-block, then _channel_sums. nav_gather: the mask-table variant."""
    return _channel_sums(_wire_fields(wire, sub_blocks), ca_words, n_chan,
                         _wire_masks(wire, nav_gather))


# ---------------------------------------------------------------------------
# The kernel's schedule in plain torch, for the tests: the same channel
# sums as _channel_sums, computed the way csrc/synth.cu computes them.
# ---------------------------------------------------------------------------


def sign_words(f: dict, ca_words, n_chan: int, masks=None,
               no_nav: bool = False):
    """The sign words of csrc/synth.cu's block prologue (nav_bit,
    finish_chan and sign_word; built in synth_block before its channel
    loop) for the first n_chan channels of the fields `f` of
    _channel_sums: ([B, SB, n_chan, SIGN_WORDS] int64 words holding uint32
    values, [B, SB, n_chan] words read). Bit j of word k is C/A bit xor
    nav bit of the chip chip_first + 32 k + j chips after the start of the
    sub-block's first code period Mfirst: one bit per chip of the sub-block,
    across its code periods. The nav bit of each of the PERIODS periods
    from Mfirst follows the walk, or with `masks` ([B, C, 128]) lane
    M & 127, or with no_nav (the no_nav_walk ablation) is 0. Words past
    those read are 0. Raises ValueError where a sub-block spans more chips
    than SIGN_WORDS * 32 (the kernel traps)."""
    B, SB = f["code_base"].shape[:2]
    dev = ca_words.device

    def col(name):                                   # [B, SB, n]
        return f[name][:, :, :n_chan].expand(B, SB, n_chan)

    t_base = _wrap32(col("t_base"))
    m_first = floor_div(t_base, CA_SEQ_LEN)
    chip_first = t_base - CA_SEQ_LEN * m_first
    span = (col("code_base") + (SUBBLOCK - 1) * col("code_step")) >> 40
    if bool((span >= SIGN_WORDS * 32).any()):
        raise ValueError(f"a sub-block spans {int(span.max()) + 1} chips, "
                         f"more than the kernel's {SIGN_WORDS * 32}")
    n_words = (span >> 5) + 1
    M = m_first[..., None] + torch.arange(PERIODS, device=dev)
    if no_nav:
        nav = torch.zeros_like(M)
    elif masks is None:
        nav = shr_signfill(col("navbits")[..., None],
                           floor_div(col("m0r")[..., None] + M, 20)) & 1
    else:
        lanes = masks[:, None, :n_chan].expand(B, SB, n_chan, 128)
        nav = torch.gather(lanes, 3, M & 127) & 1    # [B, SB, n, PERIODS]
    k = torch.arange(SIGN_WORDS, device=dev)
    pos = chip_first[..., None] + 32 * k             # [B, SB, n, W]
    period = pos // CA_SEQ_LEN
    chip = pos - CA_SEQ_LEN * period
    ca = (ca_words[:n_chan].to(torch.int64) & 0xFFFFFFFF)[None, None].expand(
        B, SB, n_chan, 32)
    a = chip >> 5
    pair = (torch.gather(ca, 3, (a + 1) & 31) << 32) | torch.gather(ca, 3, a)
    word = (pair >> (chip & 31)) & 0xFFFFFFFF
    word ^= torch.gather(nav, 3, period) * 0xFFFFFFFF
    left = (CA_SEQ_LEN - chip).clamp(max=32)         # chips left in period
    low = (1 << left) - 1
    nxt = ((ca[..., :1] << left) & 0xFFFFFFFF) ^ (
        torch.gather(nav, 3, period + 1) * 0xFFFFFFFF)
    word = (word & low) | (nxt & ~low & 0xFFFFFFFF)
    return torch.where(k < n_words[..., None], word, 0), n_words


def schedule_sums(wire, ca_words, n_chan: int, sub_blocks: int,
                  nav_gather: bool = False, ablate=frozenset()):
    """Channel sums (I, Q) of a wire, int64 [B, SB, SUBBLOCK] before the
    int32 wrap, in csrc/synth.cu's schedule (synth_block: its table of
    +-(cos, sin) and its channel loop): thread t of
    THREADS owns samples t + THREADS * k, k < SAMPLES_PER_THREAD; per
    channel it computes its first phases once and then steps them by
    THREADS * step exactly (the kernel's add.cc / addc chain on the
    fraction held in the top 40 bits of 64 carries into the chip count as
    the carry of a 40-bit fraction does here); the sign comes from the
    sign words (sign_words) at the chip count since the sub-block's first
    sample, and selects entry 2 * idx + sign of a table of +-(cos, sin).
    Used by the tests, to hold the schedule to _channel_sums.

    ablate: a set of ABLATE_BITS' names (the cost centres of csrc/synth.cu's
    Ablate bits), the stand-ins of an ablated instantiation
    (csrc/synth_profile.cu; its plain version): no_trig_gather adds
    gain * idx2 to both sums in place of the table pair, no_ca_gather takes
    the sign from bit 0 of the chip count in place of the sign word,
    no_nav_walk builds the sign words with every nav bit 0. Such sums are
    wrong by design."""
    ablate = frozenset(ablate)
    unknown = ablate - ABLATE_BITS.keys()
    if unknown:
        raise ValueError(f"unknown ablation {sorted(unknown)}; the centres "
                         f"are {sorted(ABLATE_BITS)}")
    f = _wire_fields(wire, sub_blocks)
    dev = ca_words.device
    words, _ = sign_words(f, ca_words, n_chan, _wire_masks(wire, nav_gather),
                          no_nav="no_nav_walk" in ablate)
    B, SB = f["code_base"].shape[:2]
    tbl = trig_table(dev).to(torch.int64)
    pairs = torch.stack([tbl[1], tbl[0]], dim=-1)    # (cos, sin)
    trig = torch.stack([pairs, -pairs], dim=1).reshape(1024, 2)
    t = torch.arange(THREADS, device=dev, dtype=torch.int64)
    iacc = torch.zeros((B, SB, SAMPLES_PER_THREAD, THREADS),
                       dtype=torch.int64, device=dev)
    qacc = torch.zeros_like(iacc)
    for c in range(n_chan):
        def col(name):                               # [B, SB or 1, 1]
            return f[name][:, :, c, None]

        code = col("code_base") + t * col("code_step")
        chips, frac = code >> 40, code & _MASK40
        d = THREADS * col("code_step")
        carr = (col("carr_base") + t * col("carr_step")) & _MASK40
        carr_d = (THREADS * col("carr_step")) & _MASK40
        wc = words[:, :, c].expand(B, SB, SIGN_WORDS)
        for k in range(SAMPLES_PER_THREAD):
            if k:
                frac = frac + (d & _MASK40)
                chips = chips + (d >> 40) + (frac >> 40)
                frac = frac & _MASK40
                carr = (carr + carr_d) & _MASK40
            if "no_ca_gather" in ablate:
                sign = chips & 1
            else:
                w = torch.gather(wc, 2, (chips >> 5).expand(B, SB, THREADS))
                sign = (w >> (chips & 31)) & 1
            idx2 = ((carr >> 30) & ~1) | sign
            if "no_trig_gather" in ablate:
                cs = idx2[..., None].expand(*idx2.shape, 2)
            else:
                cs = trig[idx2]                      # [B, SB, T, 2]
            iacc[:, :, k] += col("gain") * cs[..., 0]
            qacc[:, :, k] += col("gain") * cs[..., 1]
    return (iacc.reshape(B, SB, SUBBLOCK), qacc.reshape(B, SB, SUBBLOCK))


def _quantize_acc(acc: torch.Tensor) -> torch.Tensor:
    """(acc + 64) >> 7 of int32 channel sums (any integer dtype, values
    taken mod 2^32 like int32), as int64, before the int16 wrap."""
    return _wrap32(_wrap32(acc.to(torch.int64)) + 64) >> 7


def quantize_int16(acc: torch.Tensor) -> torch.Tensor:
    """(acc + 64) >> 7 of int32 channel sums, wrapped to int16."""
    return _wrap16(_quantize_acc(acc)).to(torch.int16)


def _quantized_iq(wire, ca_words, n_chan: int, sub_blocks: int,
                  nav_gather: bool = False):
    """(I, Q) after (acc + 64) >> 7, int64 [B, SB, SUBBLOCK], before the
    int16 wrap."""
    iacc, qacc = _accumulate_iq(wire, ca_words, n_chan, sub_blocks,
                                nav_gather)
    return _quantize_acc(iacc), _quantize_acc(qacc)


def _pack_words(i16: torch.Tensor, q16: torch.Tensor,
                fmt: int) -> torch.Tensor:
    """(I, Q) after (acc + 64) >> 7, int64 [B, SB, SUBBLOCK] before the
    int16 wrap -> [B, SB * SUBBLOCK / div] int32 words of format fmt."""
    B = i16.shape[0]
    i16 = i16.reshape(B, -1)
    q16 = q16.reshape(B, -1)
    if fmt == 16:
        words = (i16 & 0xFFFF) | (q16 << 16)
    elif fmt == 8:
        ib = (_wrap16(i16) >> 4) & 0xFF
        qb = (_wrap16(q16) >> 4) & 0xFF
        pair = (ib | (qb << 8)).reshape(B, -1, 2)
        words = pair[..., 0] | (pair[..., 1] << 16)
    elif fmt == 1:
        k = torch.arange(16, device=i16.device, dtype=torch.int64)
        bit = 8 * (k >> 2) + 7 - 2 * (k & 3)
        ib = (_wrap16(i16) > 0).to(torch.int64).reshape(B, -1, 16)
        qb = (_wrap16(q16) > 0).to(torch.int64).reshape(B, -1, 16)
        words = ((ib << bit) | (qb << (bit - 1))).sum(dim=-1)
    else:
        raise ValueError(f"Invalid I/Q data format: {fmt}")
    return _wrap32(words).to(torch.int32)


def synth_wire_ref(wire: torch.Tensor, ca_words: torch.Tensor, n_chan: int,
                   n_out: int, fmt: int,
                   nav_gather: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same words, any device."""
    i16, q16 = _quantized_iq(wire, ca_words, n_chan, -(-n_out // SUBBLOCK),
                             nav_gather)
    return _pack_words(i16, q16, fmt)


def schedule_words(wire: torch.Tensor, ca_words: torch.Tensor, n_chan: int,
                   n_out: int, fmt: int, ablate=frozenset()) -> torch.Tensor:
    """The packed words of schedule_sums (window walk): with an empty
    `ablate` the words of synth_wire_ref; with an ablation set the plain
    version of that ablated instantiation (csrc/synth_profile.cu), whose
    words are wrong by design."""
    i, q = schedule_sums(wire, ca_words, n_chan, -(-n_out // SUBBLOCK),
                         ablate=ablate)
    return _pack_words(_quantize_acc(i), _quantize_acc(q), fmt)


def synth_wire_planes_ref(wire: torch.Tensor, ca_words: torch.Tensor,
                          n_chan: int, n_out: int, nav_gather: bool = False):
    """Plain version of the planes mode: (I, Q), each [B, SB * SUBBLOCK]
    int16, (acc + 64) >> 7 wrapped to int16."""
    B = wire.shape[0]
    i, q = _accumulate_iq(wire, ca_words, n_chan, -(-n_out // SUBBLOCK),
                          nav_gather)
    return tuple(quantize_int16(x).reshape(B, -1) for x in (i, q))


def synth_wire_raw_ref(wire: torch.Tensor, ca_words: torch.Tensor,
                       n_chan: int, n_out: int, nav_gather: bool = False):
    """Plain version of the raw mode: (I, Q), each [B, SB * SUBBLOCK]
    int32, the channel sums wrapped mod 2^32 before the rounding shift."""
    B = wire.shape[0]
    i, q = _accumulate_iq(wire, ca_words, n_chan, -(-n_out // SUBBLOCK),
                          nav_gather)
    return tuple(_wrap32(x).reshape(B, -1).to(torch.int32) for x in (i, q))


def _row_sums(rows: torch.Tensor, ca_words: torch.Tensor):
    """Channel sums (I, Q) of [B, SB, C, ROW_LANES] rows over all C
    channels, int64 [B, SB, SUBBLOCK], before the int32 wrap."""
    w = rows.to(torch.int64)

    def u64(lane):
        return (w[..., lane] & 0xFFFFFFFF) | (w[..., lane + 1] << 32)

    f = dict(code_base=u64(0), code_step=u64(2), carr_base=u64(4),
             carr_step=u64(6), t_base=w[..., 8], m0r=w[..., 9],
             navbits=w[..., 10], gain=w[..., 11])
    return _channel_sums(f, ca_words, rows.shape[2])


def synth_rows_planes_ref(rows: torch.Tensor, ca_words: torch.Tensor):
    """Plain version of the row kernel's planes mode: (I, Q), each
    [B, SB * SUBBLOCK] int16, (acc + 64) >> 7 wrapped to int16."""
    B = rows.shape[0]
    return tuple(quantize_int16(x).reshape(B, -1)
                 for x in _row_sums(rows, ca_words))


def synth_rows_raw_ref(rows: torch.Tensor, ca_words: torch.Tensor):
    """Plain version of the row kernel's raw mode: (I, Q), each
    [B, SB * SUBBLOCK] int32 channel sums wrapped mod 2^32."""
    B = rows.shape[0]
    return tuple(_wrap32(x).reshape(B, -1).to(torch.int32)
                 for x in _row_sums(rows, ca_words))


# ---------------------------------------------------------------------------
# The wrappers.
# ---------------------------------------------------------------------------


def _check(wire, ca_words, n_chan: int, n_out: int) -> None:
    if wire.dtype != torch.int32 or ca_words.dtype != torch.int32:
        raise TypeError("wire and ca_words must be int32")
    if wire.dim() != 3 or wire.shape[2] != WIRE_LANES:
        raise ValueError(f"wire must be [B, C, {WIRE_LANES}], "
                         f"got {tuple(wire.shape)}")
    if not 1 <= wire.shape[0] <= 65535:
        raise ValueError(f"epoch count {wire.shape[0]} outside [1, 65535]")
    C = wire.shape[1]
    if tuple(ca_words.shape) != (C, 32):
        raise ValueError(f"ca_words must be [{C}, 32], "
                         f"got {tuple(ca_words.shape)}")
    if not 1 <= n_chan <= min(C, MAX_CHAN):
        raise ValueError(f"n_chan {n_chan} outside [1, {min(C, MAX_CHAN)}]")
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    if wire.device != ca_words.device:
        raise ValueError("wire and ca_words are on different devices")
    if not (wire.is_contiguous() and ca_words.is_contiguous()):
        raise ValueError("wire and ca_words must be contiguous")
    if wire.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {wire.device}")


def _count(key: str, nav_gather: bool) -> None:
    launch_counts[key + "_nav" if nav_gather else key] += 1


def synth_wire(wire: torch.Tensor, ca_words: torch.Tensor, n_chan: int,
               n_out: int, fmt: int, nav_gather: bool = False,
               timing: list = None) -> torch.Tensor:
    """[B, C, 12] wire -> [B, words_per_epoch(n_out, fmt)] int32 words.

    CUDA tensors go through the hand-written kernel (a build or launch
    failure raises); CPU tensors through synth_wire_ref. timing: on a CUDA
    tensor, a (start, end) pair of timing events recorded on the current
    stream right before and right after the launch is appended to it."""
    if fmt not in PACK_DIV:
        raise ValueError(f"Invalid I/Q data format: {fmt}")
    _check(wire, ca_words, n_chan, n_out)
    if wire.device.type == "cpu":
        return synth_wire_ref(wire, ca_words, n_chan, n_out, fmt, nav_gather)
    from gps_sdr_sim_tpu_torch.ops import synth_cuda

    out = torch.empty((wire.shape[0], words_per_epoch(n_out, fmt)),
                      dtype=torch.int32, device=wire.device)
    table = trig_table(wire.device)
    if timing is not None:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    synth_cuda.launch(wire, ca_words, table, out, n_chan,
                      -(-n_out // SUBBLOCK), fmt, nav_gather)
    if timing is not None:
        ev[1].record()
        timing.append(ev)
    _count("synth_wire", nav_gather)
    return out


def _synth_iq(wire, ca_words, n_chan: int, n_out: int, quantize: bool,
              nav_gather: bool):
    _check(wire, ca_words, n_chan, n_out)
    if wire.device.type == "cpu":
        ref = synth_wire_planes_ref if quantize else synth_wire_raw_ref
        return ref(wire, ca_words, n_chan, n_out, nav_gather)
    from gps_sdr_sim_tpu_torch.ops import synth_cuda

    sub_blocks = -(-n_out // SUBBLOCK)
    dtype = torch.int16 if quantize else torch.int32
    out_i, out_q = (torch.empty((wire.shape[0], sub_blocks * SUBBLOCK),
                                dtype=dtype, device=wire.device)
                    for _ in range(2))
    synth_cuda.launch_iq(wire, ca_words, trig_table(wire.device), out_i,
                         out_q, n_chan, sub_blocks, quantize, nav_gather)
    _count("synth_wire_planes" if quantize else "synth_wire_raw", nav_gather)
    return out_i, out_q


def synth_wire_planes(wire: torch.Tensor, ca_words: torch.Tensor,
                      n_chan: int, n_out: int, nav_gather: bool = False):
    """[B, C, 12] wire -> (I, Q), each [B, SB * SUBBLOCK] int16: the
    Pallas kernel's quantize=True, fmt=None variant.

    CUDA tensors go through the hand-written kernel (a build or launch
    failure raises); CPU tensors through synth_wire_planes_ref."""
    return _synth_iq(wire, ca_words, n_chan, n_out, True, nav_gather)


def synth_wire_raw(wire: torch.Tensor, ca_words: torch.Tensor, n_chan: int,
                   n_out: int, nav_gather: bool = False):
    """[B, C, 12] wire -> (I, Q), each [B, SB * SUBBLOCK] int32 channel
    sums before (acc + 64) >> 7: the Pallas kernel's quantize=False
    variant, a chan shard's partial sums.

    CUDA tensors go through the hand-written kernel (a build or launch
    failure raises); CPU tensors through synth_wire_raw_ref."""
    return _synth_iq(wire, ca_words, n_chan, n_out, False, nav_gather)


def synth_staged_packed(staged: Staged, n_out: int, fmt: int = 16,
                        plain: bool = False, nav_gather: bool = False,
                        timing: list = None) -> torch.Tensor:
    """Staged batch -> [B, words] int32 output words (see module doc);
    plain=True runs synth_wire_ref on the staged device instead. timing:
    as synth_wire's (the plain version records nothing)."""
    args = (staged.wire, staged.ca_words, staged.n_chan, n_out, fmt,
            nav_gather)
    with spans.span("synth.launch"):
        if plain:
            return synth_wire_ref(*args)
        return synth_wire(*args, timing=timing)


def _check_rows(rows: torch.Tensor, ca_words: torch.Tensor) -> None:
    if rows.dtype != torch.int32 or ca_words.dtype != torch.int32:
        raise TypeError("rows and ca_words must be int32")
    if rows.dim() != 4 or rows.shape[3] != ROW_LANES:
        raise ValueError(f"rows must be [B, SB, C, {ROW_LANES}], "
                         f"got {tuple(rows.shape)}")
    B, SB, C = rows.shape[:3]
    if not 1 <= B <= 65535 or SB < 1:
        raise ValueError(f"rows hold {B} epochs of {SB} sub-blocks; need "
                         f"1 to 65535 epochs and at least one sub-block")
    if not 1 <= C <= MAX_CHAN:
        raise ValueError(f"{C} channels outside [1, {MAX_CHAN}]")
    if tuple(ca_words.shape) != (C, 32):
        raise ValueError(f"ca_words must be [{C}, 32], "
                         f"got {tuple(ca_words.shape)}")
    if rows.device != ca_words.device:
        raise ValueError("rows and ca_words are on different devices")
    if not (rows.is_contiguous() and ca_words.is_contiguous()):
        raise ValueError("rows and ca_words must be contiguous")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {rows.device}")


def _synth_rows(rows, ca_words, quantize: bool):
    _check_rows(rows, ca_words)
    if rows.device.type == "cpu":
        ref = synth_rows_planes_ref if quantize else synth_rows_raw_ref
        return ref(rows, ca_words)
    from gps_sdr_sim_tpu_torch.ops import synth_cuda

    B, SB = rows.shape[:2]
    dtype = torch.int16 if quantize else torch.int32
    out_i, out_q = (torch.empty((B, SB * SUBBLOCK), dtype=dtype,
                                device=rows.device) for _ in range(2))
    synth_cuda.launch_rows(rows, ca_words, trig_table(rows.device), out_i,
                           out_q, quantize)
    launch_counts["synth_rows_planes" if quantize else "synth_rows_raw"] += 1
    return out_i, out_q


def synth_rows_planes(rows: torch.Tensor, ca_words: torch.Tensor):
    """[B, SB, C, ROW_LANES] rows -> (I, Q), each [B, SB * SUBBLOCK] int16,
    the sum of all C channels after (acc + 64) >> 7: the Pallas kernel's
    row-parameter form (uniform=False), quantize=True.

    CUDA tensors go through the hand-written kernel (a build or launch
    failure raises); CPU tensors through synth_rows_planes_ref."""
    return _synth_rows(rows, ca_words, True)


def synth_rows_raw(rows: torch.Tensor, ca_words: torch.Tensor):
    """[B, SB, C, ROW_LANES] rows -> (I, Q), each [B, SB * SUBBLOCK] int32
    channel sums before (acc + 64) >> 7: the row-parameter form with
    quantize=False, a chan shard's partial sums.

    CUDA tensors go through the hand-written kernel (a build or launch
    failure raises); CPU tensors through synth_rows_raw_ref."""
    return _synth_rows(rows, ca_words, False)


def synth_batch(db, n_out: int, device) -> torch.Tensor:
    """DeviceBatch -> [B, n_out, 2] int16 on `device` through the row
    kernel's planes mode: the counterpart of
    gps_sdr_sim_tpu/ops/synth_pallas.py:synth_batch. The rows go up pinned
    and without blocking the host."""
    device = torch.device(device)
    i16, q16 = synth_rows_planes(upload_rows(pack_rows(db), device),
                                 ca_device(db.ca_words, device))
    return torch.stack([i16[:, :n_out], q16[:, :n_out]], dim=-1)
