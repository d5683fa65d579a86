// Fused GPS L1 C/A I/Q synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces gps_sdr_sim_tpu/ops/synth_pallas.py: the Pallas kernel
// `_make_kernel` (per-sample synthesis, summed over channels) together with
// the XLA prologue `_wire_to_params` / `_device_rebase` / `_unpack_wire`
// (the exact per-sub-block phase rebase). The rebase runs here in the block
// prologue, so no per-sub-block parameter array ever reaches device memory.
//
// Input forms, one kernel each:
//   * synth_wire_kernel reads the [B, C, 12] wire (the per-epoch form) and
//     rebases each channel's phases to the block's sub-block in its
//     prologue;
//   * synth_rows_kernel reads one row per (epoch, sub-block, channel) that
//     the host has already rebased (ops/synth.py pack_rows, from the
//     DeviceBatch of plan_batch). It replaces the K1 row-parameter form:
//     `_get_pallas_fn` with `uniform=False` (synth_pallas.py:508), its
//     parameter rows from `pack_params` (:617), and its callers
//     `synth_batch` (:654) and parallel/shard.py `synth_pallas_sharded`
//     (:114, :224). Its output modes are kPlanes and kRaw, with the nav
//     window walk (the mask table needs the wire's epoch-aligned form, as
//     `tpe > 0` needs `uniform` on the TPU). What differs from the wire
//     form: no rebase on the card, and the row parameters come from device
//     memory, 48 bytes per (epoch, sub-block, channel) (9.75 MB for a
//     100-epoch 2.6 Msps batch, a tenth of the planes it writes; the TPU's
//     rows hold the same integers in 20-bit limbs, 128 bytes each). The
//     rows carry all 16 DeviceBatch channels; the prologue keeps the ones
//     whose gain is not 0 (a warp ballot), so inactive channels and padded
//     epochs cost no loop trips. A zero gain adds exactly 0, so the sums
//     are those of every channel. Like the wire form it is bounded by the
//     integer issue rate: the loop body is the same accumulate_iq.
//
// Output modes (the template value MODE), one per K1 variant:
//   * kPacked: quantized and packed into the final SC16/SC08/SC01 words
//     (`fmt` 16/8/1; the single-device path);
//   * kPlanes: two int16 planes I and Q, (acc + 64) >> 7 wrapped to int16
//     (`quantize=True, fmt=None`; the time-only sharded path,
//     gps_sdr_sim_tpu/parallel/shard.py:158 with chan_n == 1);
//   * kRaw: two int32 planes of the wrapped channel sums before the
//     rounding shift (`quantize=False`; a chan shard's partial sums, which
//     the caller adds across the chan axis before quantizing, shard.py:170).
//
// The nav sign (the template value NAV), in every mode:
//   * NAV = false, the window walk: bit floor((m0r + M) / 20) of the nav
//     window, a floor division and a sign-filling shift per (sample,
//     channel);
//   * NAV = true, the mask table: the K1 `tpe > 0` variant
//     (synth_pallas.py:377-393 body, :565-575 operand, nav_masks and
//     nav_table_from_wire :706-733). Lane m of a channel's 128-entry table
//     is bit clip(floor((m0 + m) / 20) - b0, 0, 31) of the window, and code
//     period M reads lane M & 127 (M = -1 reads lane 127, as the TPU kernel
//     does; the walk's sign fill reads the window's bit 31 there instead).
//     The TPU kernel takes the table as a [B*C, 128] int32 operand with a
//     block per epoch; here the block prologue builds it from the wire, as
//     4 x 32 bits per channel in shared memory, so nothing extra goes
//     through device memory. The lookup is one shared load and two shifts
//     in place of the walk's division by 20 (a multiply-high and fix-ups),
//     shift, compare and select; M is nearly uniform across a warp, so the
//     load is a broadcast.
//
// Arithmetic contract (identical to ops/plan.py and synth_pallas.py, so the
// output words are bit-identical):
//   * phases and steps are 2^56-scaled unsigned integers taken from the
//     [B, C, 12] int32 wire of plan.pack_epoch_wire;
//   * every SUBBLOCK samples the phase is re-anchored exactly:
//       lo = (f & 0xFFFF) + k0 * (s & 0xFFFF)
//       hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16)      (units 2^-40)
//     base40 = hi mod 2^40, carry = hi >> 40 (whole chips);
//   * inside a sub-block the ramp uses the step's bits [16, 64) only:
//       T   = t0 + carry + ((base40 + r * (s >> 16)) >> 40)
//       idx = ((base40c + r * (cs >> 16)) >> 31) & 0x1FF;
//   * M and the nav bit index are FLOOR divisions (T = -1 is reachable),
//     and a nav-window shift outside [0, 32) sign-fills, as XLA defines it;
//   * channel sums wrap mod 2^32 like int32; (acc + 64) >> 7 is arithmetic;
//     the int16 wrap precedes SC08's >> 4 and SC01's sign test.
//
// What bounds it on an H100: integer ALU issue rate. Each (sample, channel)
// costs two 64-bit multiply-adds, one or two floor divisions, two or three
// shared-memory lookups (C/A word, sin/cos, the nav table) and ~20 other
// integer ops; the channel loop is kept rolled so that its instruction
// count is the per-(sample, channel) cost (chip_smoke.py reads it from
// cuobjdump -sass). SC16 writes 4 bytes per sample, kRaw 8 (3.1 and 6.2 GB
// for the 300 s canonical run), which at HBM rates is far below the ALU
// time. This first design is the simple one: one block per (sub-block,
// epoch), 128 threads, each thread writing whole 32-bit output words, the
// 512-entry sin/cos table, the C/A words, the nav tables and the rebased
// channel parameters held in shared memory. It recomputes the ramps with
// multiplies instead of stepping them, and it does not specialise on the
// rate or the gain. Those are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSubblock = 2048;  // gps_sdr_sim_tpu_torch.constants.SUBBLOCK
constexpr int kMaxChan = 16;     // gps_sdr_sim_tpu_torch.constants.MAX_CHAN
constexpr int kWireLanes = 12;   // gps_sdr_sim_tpu_torch.ops.plan.WIRE_LANES
constexpr int kRowLanes = 12;    // gps_sdr_sim_tpu_torch.ops.synth.ROW_LANES
constexpr int kThreads = 128;
constexpr int kCaLen = 1023;
constexpr uint64_t kMask40 = (uint64_t(1) << 40) - 1;

struct Chan {
  uint64_t code_base;  // fractional code phase at k0, units 2^-40 chip
  uint64_t code_step;  // code step bits [16, 64), units 2^-40 chip
  uint64_t carr_base;  // fractional carrier phase at k0, units 2^-40 cycle
  uint64_t carr_step;
  int32_t t_base;      // whole chips since epoch start at k0
  int32_t m0r;         // nav ms counter modulo the 20-ms bit (m0 - 20*b0)
  int32_t navbits;     // nav bit window starting at bit b0
  int32_t gain;
};

// floor(a / b) for b > 0; C++ division truncates toward zero.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Arithmetic right shift with XLA's rule for out-of-range amounts: a shift
// below 0 or above 31 fills with the sign bit (C++ leaves it undefined).
__device__ __forceinline__ int shr_signfill(int x, int s) {
  return (s < 0 || s > 31) ? (x >> 31) : (x >> s);
}

// The unsigned 64-bit value in lanes (lane, lane + 1), low word first.
__device__ __forceinline__ uint64_t lanes_u64(const int32_t* w, int lane) {
  return uint64_t(uint32_t(w[lane])) | (uint64_t(uint32_t(w[lane + 1])) << 32);
}

// Word k (lanes 32k .. 32k+31) of a channel's nav mask table: bit m is the
// nav bit of code period m0 + 32k + m, window bit
// clip(floor((m0 + 32k + m) / 20) - b0, 0, 31). m0 >= 0 (16 bits), so the
// division needs no floor fix-up.
__device__ __forceinline__ uint32_t nav_table_word(const int32_t* w, int k) {
  const int32_t m0 = w[9] & 0xFFFF, b0 = w[9] >> 16, navbits = w[10];
  uint32_t word = 0;
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    int j = (m0 + 32 * k + m) / 20 - b0;
    j = j < 0 ? 0 : (j > 31 ? 31 : j);
    word |= uint32_t((navbits >> j) & 1) << m;
  }
  return word;
}

// Channel sums (I, Q) of in-sub-block sample r over the first n_chan
// channels, wrapped mod 2^32 like int32. nav: the channels' mask tables
// (4 words each; read only when NAV).
template <bool NAV>
__device__ __forceinline__ void accumulate_iq(int r, int n_chan,
                                              const Chan* ch,
                                              const uint32_t* ca,
                                              const uint32_t* nav,
                                              const int32_t* sin_t,
                                              const int32_t* cos_t,
                                              uint32_t* i_acc,
                                              uint32_t* q_acc) {
  uint32_t iacc = 0, qacc = 0;
#pragma unroll 1
  for (int c = 0; c < n_chan; ++c) {
    const Chan& p = ch[c];
    uint64_t code = p.code_base + uint64_t(r) * p.code_step;
    int T = int(uint32_t(p.t_base) + uint32_t(code >> 40));
    int M = floor_div(T, kCaLen);
    int chip = T - kCaLen * M;
    int ca_bit = (ca[c * 32 + (chip >> 5)] >> (chip & 31)) & 1;
    int nav_bit;
    if constexpr (NAV) {
      const uint32_t lane = uint32_t(M) & 127u;
      nav_bit = int(nav[c * 4 + (lane >> 5)] >> (lane & 31u)) & 1;
    } else {
      int j = floor_div(p.m0r + M, 20);
      nav_bit = shr_signfill(p.navbits, j) & 1;
    }
    uint64_t carr = p.carr_base + uint64_t(r) * p.carr_step;
    int idx = int(carr >> 31) & 0x1FF;
    uint32_t neg = 0u - uint32_t(ca_bit ^ nav_bit);  // 0 or all ones
    uint32_t vc = uint32_t(p.gain) * uint32_t(cos_t[idx]);
    uint32_t vs = uint32_t(p.gain) * uint32_t(sin_t[idx]);
    iacc += (vc ^ neg) - neg;
    qacc += (vs ^ neg) - neg;
  }
  *i_acc = iacc;
  *q_acc = qacc;
}

// (acc + 64) >> 7, arithmetic, before the int16 wrap.
__device__ __forceinline__ int32_t quantize(uint32_t acc) {
  return int32_t(acc + 64u) >> 7;
}

// Quantized (I, Q) of in-sub-block sample r, before the int16 wrap.
template <bool NAV>
__device__ __forceinline__ void sample_iq(int r, int n_chan, const Chan* ch,
                                          const uint32_t* ca,
                                          const uint32_t* nav,
                                          const int32_t* sin_t,
                                          const int32_t* cos_t, int32_t* i_out,
                                          int32_t* q_out) {
  uint32_t iacc, qacc;
  accumulate_iq<NAV>(r, n_chan, ch, ca, nav, sin_t, cos_t, &iacc, &qacc);
  *i_out = quantize(iacc);
  *q_out = quantize(qacc);
}

__device__ __forceinline__ int32_t wrap16(int32_t v) { return int16_t(v); }

enum Mode { kPacked = 0, kPlanes = 1, kRaw = 2 };

// Output 32-bit words per sample block of kSubblock samples (per plane for
// kPlanes and kRaw).
template <int MODE, int FMT>
__host__ __device__ constexpr int words_per_subblock() {
  return MODE == kPlanes ? kSubblock / 2
         : MODE == kRaw  ? kSubblock
         : kSubblock / (FMT == 16 ? 1 : (FMT == 8 ? 2 : 16));
}

// Row form: fill ch[] from this block's rows (one per channel, n_chan of
// them), the channels whose gain is not 0 first, and their C/A words into
// ca[]; the number of them goes to *n_live. Warp 0 reads the rows (n_chan
// <= 16) and places each kept channel by a ballot. Ends with a barrier.
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ rows,
                                          const int32_t* __restrict__ ca_words,
                                          int n_chan, Chan* ch, uint32_t* ca,
                                          int* chan_of, int* n_live) {
  if (threadIdx.x < 32) {
    const int c = threadIdx.x;
    Chan p;
    bool live = false;
    if (c < n_chan) {
      const int32_t* w = rows + size_t(c) * kRowLanes;
      p.code_base = lanes_u64(w, 0);
      p.code_step = lanes_u64(w, 2);
      p.carr_base = lanes_u64(w, 4);
      p.carr_step = lanes_u64(w, 6);
      p.t_base = w[8];
      p.m0r = w[9];
      p.navbits = w[10];
      p.gain = w[11];
      live = p.gain != 0;
    }
    const uint32_t kept = __ballot_sync(0xFFFFFFFFu, live);
    if (live) {
      const int k = __popc(kept & ((1u << c) - 1u));
      ch[k] = p;
      chan_of[k] = c;
    }
    if (c == 0) *n_live = __popc(kept);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < *n_live * 32; i += kThreads) {
    ca[i] = uint32_t(ca_words[chan_of[i >> 5] * 32 + (i & 31)]);
  }
}

// One block: sub-block blockIdx.x of epoch blockIdx.y. ROWS: `params` are
// the [B, SB, param_chans, 12] rows and every channel is summed; else the
// [B, param_chans, 12] wire, of which the first n_chan channels are summed.
// out: the packed words (kPacked) or the I plane; out_q: the Q plane
// (kPlanes, kRaw; unused for kPacked).
template <int MODE, int FMT, bool NAV, bool ROWS>
__device__ __forceinline__ void synth_block(
    const int32_t* __restrict__ params, const int32_t* __restrict__ ca_words,
    const int32_t* __restrict__ table, int32_t* __restrict__ out,
    int32_t* __restrict__ out_q, int param_chans, int n_chan) {
  constexpr int kWords = words_per_subblock<MODE, FMT>();

  __shared__ int32_t sin_t[512];
  __shared__ int32_t cos_t[512];
  __shared__ uint32_t ca[kMaxChan * 32];
  __shared__ uint32_t nav[kMaxChan * 4];
  __shared__ Chan ch[kMaxChan];
  __shared__ int chan_of[kMaxChan];
  __shared__ int n_live;

  const int sb = blockIdx.x;
  const int b = blockIdx.y;
  const int sub_blocks = gridDim.x;

  for (int i = threadIdx.x; i < 512; i += kThreads) {
    sin_t[i] = table[i];
    cos_t[i] = table[512 + i];
  }
  if constexpr (ROWS) {
    load_rows(params + (size_t(b) * sub_blocks + sb) * param_chans * kRowLanes,
              ca_words, n_chan, ch, ca, chan_of, &n_live);
  } else {
    for (int i = threadIdx.x; i < n_chan * 32; i += kThreads) {
      ca[i] = uint32_t(ca_words[i]);
    }
    if (threadIdx.x < n_chan) {
      const int32_t* w =
          params + (size_t(b) * param_chans + threadIdx.x) * kWireLanes;
      const uint64_t k0 = uint64_t(sb) * kSubblock;
      Chan p;
      {
        uint64_t f = lanes_u64(w, 0), s = lanes_u64(w, 2);
        uint64_t lo = (f & 0xFFFF) + k0 * (s & 0xFFFF);
        uint64_t hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16);
        p.code_base = hi & kMask40;
        p.code_step = s >> 16;
        p.t_base = int32_t(uint32_t(w[8]) + uint32_t(hi >> 40));
      }
      {
        uint64_t f = lanes_u64(w, 4), s = lanes_u64(w, 6);
        uint64_t lo = (f & 0xFFFF) + k0 * (s & 0xFFFF);
        uint64_t hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16);
        p.carr_base = hi & kMask40;
        p.carr_step = s >> 16;
      }
      const int32_t m0 = w[9] & 0xFFFF, b0 = w[9] >> 16;
      p.m0r = m0 - 20 * b0;
      p.navbits = w[10];
      p.gain = w[11];
      ch[threadIdx.x] = p;
    }
    if constexpr (NAV) {
      // Four threads per channel, one table word each (n_chan * 4 <= 64).
      if (threadIdx.x < n_chan * 4) {
        const int32_t* w = params + (size_t(b) * param_chans +
                                     (threadIdx.x >> 2)) * kWireLanes;
        nav[threadIdx.x] = nav_table_word(w, threadIdx.x & 3);
      }
    }
  }
  __syncthreads();
  if constexpr (ROWS) n_chan = n_live;

  const size_t row = (size_t(b) * sub_blocks + sb) * kWords;
  int32_t* o = out + row;
  for (int wi = threadIdx.x; wi < kWords; wi += kThreads) {
    int32_t iv, qv;
    if constexpr (MODE == kPlanes) {
      // Two adjacent int16 samples per word and plane, the earlier one in
      // the low half (little-endian int16 order).
      uint32_t i_lo, q_lo, i_hi, q_hi;
      accumulate_iq<NAV>(2 * wi, n_chan, ch, ca, nav, sin_t, cos_t, &i_lo,
                         &q_lo);
      accumulate_iq<NAV>(2 * wi + 1, n_chan, ch, ca, nav, sin_t, cos_t, &i_hi,
                         &q_hi);
      o[wi] = int32_t((uint32_t(quantize(i_lo)) & 0xFFFFu) |
                      (uint32_t(quantize(i_hi)) << 16));
      out_q[row + wi] = int32_t((uint32_t(quantize(q_lo)) & 0xFFFFu) |
                                (uint32_t(quantize(q_hi)) << 16));
    } else if constexpr (MODE == kRaw) {
      uint32_t ia, qa;
      accumulate_iq<NAV>(wi, n_chan, ch, ca, nav, sin_t, cos_t, &ia, &qa);
      o[wi] = int32_t(ia);
      out_q[row + wi] = int32_t(qa);
    } else if constexpr (FMT == 16) {
      sample_iq<NAV>(wi, n_chan, ch, ca, nav, sin_t, cos_t, &iv, &qv);
      o[wi] = int32_t((uint32_t(iv) & 0xFFFFu) | (uint32_t(qv) << 16));
    } else if constexpr (FMT == 8) {
      uint32_t word = 0;
      for (int k = 0; k < 2; ++k) {
        sample_iq<NAV>(2 * wi + k, n_chan, ch, ca, nav, sin_t, cos_t, &iv,
                       &qv);
        uint32_t ib = uint32_t(wrap16(iv) >> 4) & 0xFFu;
        uint32_t qb = uint32_t(wrap16(qv) >> 4) & 0xFFu;
        word |= (ib | (qb << 8)) << (16 * k);
      }
      o[wi] = int32_t(word);
    } else {
      // 16 samples, 4 per byte, MSB-first {I0,Q0,I1,Q1,I2,Q2,I3,Q3};
      // byte k of the little-endian word holds samples 4k..4k+3.
      uint32_t word = 0;
      for (int k = 0; k < 16; ++k) {
        sample_iq<NAV>(16 * wi + k, n_chan, ch, ca, nav, sin_t, cos_t, &iv,
                       &qv);
        int bit = 8 * (k >> 2) + 7 - 2 * (k & 3);
        word |= uint32_t(wrap16(iv) > 0) << bit;
        word |= uint32_t(wrap16(qv) > 0) << (bit - 1);
      }
      o[wi] = int32_t(word);
    }
  }
}

template <int MODE, int FMT, bool NAV>
__global__ void __launch_bounds__(kThreads)
synth_wire_kernel(const int32_t* __restrict__ wire,
                  const int32_t* __restrict__ ca_words,
                  const int32_t* __restrict__ table,
                  int32_t* __restrict__ out, int32_t* __restrict__ out_q,
                  int wire_chans, int n_chan) {
  synth_block<MODE, FMT, NAV, false>(wire, ca_words, table, out, out_q,
                                     wire_chans, n_chan);
}

// MODE is kPlanes or kRaw.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
synth_rows_kernel(const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ ca_words,
                  const int32_t* __restrict__ table,
                  int32_t* __restrict__ out, int32_t* __restrict__ out_q,
                  int n_chan) {
  synth_block<MODE, 0, false, true>(rows, ca_words, table, out, out_q, n_chan,
                                    n_chan);
}

template <int MODE, int FMT, bool NAV>
int launch(const int32_t* wire, const int32_t* ca_words, const int32_t* table,
           int32_t* out, int32_t* out_q, int n_epochs, int wire_chans,
           int n_chan, int sub_blocks, void* stream) {
  dim3 grid(sub_blocks, n_epochs);
  synth_wire_kernel<MODE, FMT, NAV>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          wire, ca_words, table, out, out_q, wire_chans, n_chan);
  return int(cudaGetLastError());
}

// The walk (nav_gather = 0) or the mask-table (nav_gather = 1) variant.
template <int MODE, int FMT>
int launch_nav(const int32_t* wire, const int32_t* ca_words,
               const int32_t* table, int32_t* out, int32_t* out_q,
               int n_epochs, int wire_chans, int n_chan, int sub_blocks,
               int nav_gather, void* stream) {
  if (nav_gather) {
    return launch<MODE, FMT, true>(wire, ca_words, table, out, out_q,
                                   n_epochs, wire_chans, n_chan, sub_blocks,
                                   stream);
  }
  return launch<MODE, FMT, false>(wire, ca_words, table, out, out_q, n_epochs,
                                  wire_chans, n_chan, sub_blocks, stream);
}

bool bad_shape(int n_epochs, int wire_chans, int n_chan, int sub_blocks) {
  return n_chan < 1 || n_chan > kMaxChan || n_chan > wire_chans ||
         n_epochs < 1 || n_epochs > 65535 || sub_blocks < 1;
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success).
// wire [n_epochs, wire_chans, 12] int32, ca_words [wire_chans, 32] int32,
// table [2, 512] int32 (sin row, cos row),
// out [n_epochs, sub_blocks * 2048 / div] int32 with div = 1, 2, 16 for
// fmt = 16, 8, 1. Only the first n_chan channels are summed. nav_gather = 1
// takes the nav sign from the mask table, 0 from the window walk.
extern "C" int synth_wire_launch(const int32_t* wire, const int32_t* ca_words,
                                 const int32_t* table, int32_t* out,
                                 int n_epochs, int wire_chans, int n_chan,
                                 int sub_blocks, int fmt, int nav_gather,
                                 void* stream) {
  if (bad_shape(n_epochs, wire_chans, n_chan, sub_blocks)) {
    return int(cudaErrorInvalidValue);
  }
  switch (fmt) {
    case 16:
      return launch_nav<kPacked, 16>(wire, ca_words, table, out, nullptr,
                                     n_epochs, wire_chans, n_chan, sub_blocks,
                                     nav_gather, stream);
    case 8:
      return launch_nav<kPacked, 8>(wire, ca_words, table, out, nullptr,
                                    n_epochs, wire_chans, n_chan, sub_blocks,
                                    nav_gather, stream);
    case 1:
      return launch_nav<kPacked, 1>(wire, ca_words, table, out, nullptr,
                                    n_epochs, wire_chans, n_chan, sub_blocks,
                                    nav_gather, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The I/Q plane modes, same arguments as synth_wire_launch but two outputs:
// quantize = 1 (kPlanes): out_i, out_q [n_epochs, sub_blocks * 2048] int16;
// quantize = 0 (kRaw):    out_i, out_q [n_epochs, sub_blocks * 2048] int32.
extern "C" int synth_wire_iq_launch(const int32_t* wire,
                                    const int32_t* ca_words,
                                    const int32_t* table, void* out_i,
                                    void* out_q, int n_epochs, int wire_chans,
                                    int n_chan, int sub_blocks, int quantize,
                                    int nav_gather, void* stream) {
  if (bad_shape(n_epochs, wire_chans, n_chan, sub_blocks)) {
    return int(cudaErrorInvalidValue);
  }
  int32_t* oi = static_cast<int32_t*>(out_i);
  int32_t* oq = static_cast<int32_t*>(out_q);
  if (quantize) {
    return launch_nav<kPlanes, 0>(wire, ca_words, table, oi, oq, n_epochs,
                                  wire_chans, n_chan, sub_blocks, nav_gather,
                                  stream);
  }
  return launch_nav<kRaw, 0>(wire, ca_words, table, oi, oq, n_epochs,
                             wire_chans, n_chan, sub_blocks, nav_gather,
                             stream);
}

// The row form (synth_rows_kernel): rows [n_epochs, sub_blocks, n_chan, 12]
// int32 (ops/synth.py pack_rows), ca_words [n_chan, 32], table as above;
// every channel is summed. quantize = 1 (kPlanes): out_i, out_q
// [n_epochs, sub_blocks * 2048] int16; quantize = 0 (kRaw): the same
// shape in int32.
extern "C" int synth_rows_launch(const int32_t* rows, const int32_t* ca_words,
                                 const int32_t* table, void* out_i,
                                 void* out_q, int n_epochs, int sub_blocks,
                                 int n_chan, int quantize, void* stream) {
  if (bad_shape(n_epochs, n_chan, n_chan, sub_blocks)) {
    return int(cudaErrorInvalidValue);
  }
  dim3 grid(sub_blocks, n_epochs);
  int32_t* oi = static_cast<int32_t*>(out_i);
  int32_t* oq = static_cast<int32_t*>(out_q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantize) {
    synth_rows_kernel<kPlanes>
        <<<grid, kThreads, 0, st>>>(rows, ca_words, table, oi, oq, n_chan);
  } else {
    synth_rows_kernel<kRaw>
        <<<grid, kThreads, 0, st>>>(rows, ca_words, table, oi, oq, n_chan);
  }
  return int(cudaGetLastError());
}
