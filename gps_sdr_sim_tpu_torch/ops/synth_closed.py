"""The closed-form I/Q synthesis in plain PyTorch, from a DeviceBatch.

Counterpart of gps_sdr_sim_tpu/ops/synth_jnp.py, the JAX package's XLA
path (impl 'xla' / 'xla-sharded'): the per-sample hot loop of
gpssim.c:2190-2264 evaluated over [epochs, sub-blocks, samples] and summed
over channels, from the host-rebased DeviceBatch of ops/plan.py:plan_batch.
It runs as plain torch on whatever device it is given (runner impls
'closed' / 'closed-sharded'); it is the counterpart of an XLA path, not of
a kernel.

The parts of the arithmetic that decide bits are kept as synth_jnp has them:
the three-limb int32 ramps with their >> 16 carries, the float32 code-period
count floor((T + 0.5) * float32(1/1023)) and the float32 nav bit index
floor((mg + 0.5) * float32(1/20)). What synth_jnp does only because TPU
gathers are slow is replaced by plain indexing: the 5-level where-tree over
the 32 C/A words becomes ca_words[c][chip >> 5], and the trig polynomial
with its per-backend corrections (which make it equal the tables at every
index) becomes SIN_TABLE512/COS_TABLE512[i_tab]. The shift navbits >> j
follows XLA's rule for amounts outside [0, 32) (ops.synth.shr_signfill).

All tensors are int32 (float32 for the two floors), as in synth_jnp; int32
sums wrap mod 2^32 as XLA's do.
"""

from __future__ import annotations

import torch

from gps_sdr_sim_tpu_torch.constants import CA_SEQ_LEN, SUBBLOCK
from gps_sdr_sim_tpu_torch.ops.plan import DeviceBatch
from gps_sdr_sim_tpu_torch.ops.synth import (
    quantize_int16,
    shr_signfill,
    trig_table,
    upload,
)

# DeviceBatch fields in the order accumulate takes them (synth_jnp's).
FIELDS = ("code_s", "code_p", "carr_s", "carr_p", "t_base", "m0", "b0",
          "navbits", "gain", "ca_words")


def _f32_floor(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """floor((x + 0.5) * inv) in float32, as int32. inv is a 0-dim float32
    tensor: a Python float would be applied at the op's own precision, and
    the add and the multiply stay two roundings (no fused multiply-add in
    eager torch)."""
    return torch.floor((x.to(torch.float32) + 0.5) * inv).to(torch.int32)


def _ramp(p: torch.Tensor, s: torch.Tensor, r: torch.Tensor):
    """The three-limb int32 ramp p + r * s with its >> 16 carries: p
    [B, SB, 3], s [B, 3] -> (limb 1, limb 2) over [B, SB, SUBBLOCK]."""
    v0 = p[:, :, 0, None] + r * s[:, None, 0, None]
    v1 = p[:, :, 1, None] + r * s[:, None, 1, None] + (v0 >> 16)
    v2 = p[:, :, 2, None] + r * s[:, None, 2, None] + (v1 >> 16)
    return v1, v2


def _channel_contribution(c: int, code_s, code_p, carr_s, carr_p, t_base,
                          m0, b0, navbits, gain, ca_words, sin_t, cos_t,
                          inv1023, inv20):
    """One channel's (I, Q) int32 contribution over [B, SB, SUBBLOCK]."""
    r = torch.arange(SUBBLOCK, dtype=torch.int32, device=gain.device)

    # Code-phase ramp: chips advanced within the sub-block.
    _, v2 = _ramp(code_p[:, :, c], code_s[:, c], r)
    T = t_base[:, :, c, None] + (v2 >> 8)  # chips since epoch start

    M = _f32_floor(T, inv1023)
    chip = T - CA_SEQ_LEN * M
    word = ca_words[c][chip >> 5]
    ca_val = 2 * ((word >> (chip & 31)) & 1) - 1

    mg = m0[:, c, None, None] + M
    j = _f32_floor(mg, inv20) - b0[:, c, None, None]
    bit_val = 2 * (shr_signfill(navbits[:, c, None, None], j) & 1) - 1

    # Carrier-phase ramp -> 9-bit table index.
    w1, w2 = _ramp(carr_p[:, :, c], carr_s[:, c], r)
    i_tab = ((w2 << 1) | ((w1 >> 15) & 1)) & 0x1FF

    m = bit_val * ca_val * gain[:, c, None, None]
    return m * cos_t[i_tab], m * sin_t[i_tab]


def accumulate(code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
               ca_words):
    """Sum the int32 I/Q contributions of all C = gain.shape[1] channels.

    Returns (iacc, qacc), each [B, SB, SUBBLOCK] int32: the accumulator of
    gpssim.c:2208-2209 before the (acc + 64) >> 7 quantization. A chan
    shard's partial sums are added across shards first (the reference sums
    all channels before quantizing)."""
    dev = gain.device
    table = trig_table(dev)
    sin_t, cos_t = table[0], table[1]
    inv1023 = torch.tensor(1.0 / 1023.0, dtype=torch.float32, device=dev)
    inv20 = torch.tensor(1.0 / 20.0, dtype=torch.float32, device=dev)
    B, SB, C = t_base.shape
    iacc = torch.zeros((B, SB, SUBBLOCK), dtype=torch.int32, device=dev)
    qacc = torch.zeros_like(iacc)
    for c in range(C):
        ic, qc = _channel_contribution(
            c, code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits,
            gain, ca_words, sin_t, cos_t, inv1023, inv20)
        iacc += ic
        qacc += qc
    return iacc, qacc


def quantize_iq(iacc: torch.Tensor, qacc: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """The reference rounding (acc + 64) >> 7, wrapped to int16:
    [B, n_out, 2]."""
    B = iacc.shape[0]
    i16, q16 = (quantize_int16(a).reshape(B, -1)[:, :n_out]
                for a in (iacc, qacc))
    return torch.stack([i16, q16], dim=-1)


def synth_iq16(code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
               ca_words, *, n_out: int) -> torch.Tensor:
    """Synthesize int16 I/Q for a batch of epochs: [B, n_out, 2]."""
    return quantize_iq(*accumulate(code_s, code_p, carr_s, carr_p, t_base,
                                   m0, b0, navbits, gain, ca_words), n_out)


def batch_tensors(db: DeviceBatch, device) -> tuple:
    """The DeviceBatch's arrays in FIELDS order, on `device` (uploaded
    pinned and without blocking the host)."""
    return tuple(upload(getattr(db, f), device) for f in FIELDS)


def synth_batch(db: DeviceBatch, n_out: int, device) -> torch.Tensor:
    """DeviceBatch -> [B, n_out, 2] int16 on `device`."""
    return synth_iq16(*batch_tensors(db, device), n_out=n_out)
