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
//     rows hold the same integers in 20-bit limbs, 128 bytes each).
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
//     window, a floor division and a sign-filling shift;
//   * NAV = true, the mask table: the K1 `tpe > 0` variant
//     (synth_pallas.py:377-393 body, :565-575 operand, nav_masks and
//     nav_table_from_wire :706-733). Lane m of a channel's 128-entry table
//     is bit clip(floor((m0 + m) / 20) - b0, 0, 31) of the window, and code
//     period M reads lane M & 127 (M = -1 reads lane 127, as the TPU kernel
//     does; the walk's sign fill reads the window's bit 31 there instead).
//   The nav bit changes only between code periods, and a sub-block touches
//   at most kPeriods of them, so either rule runs once per (block, channel,
//   period) in the prologue (nav_bit); the sample loop is the same for both.
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
// What bounds it on an H100: the integer issue rate. The algorithm needs
// 14 operations per (sample, channel with gain): advance the code phase,
// whole chip, its wrap into the code period, C/A bit, nav bit, their xor,
// advance the carrier, table index, cos and sin, two gain products, two
// signed sums; quantizing adds 4 per sample. SC16 writes 4 bytes per sample, kRaw 8, far below the ALU
// time at HBM rates. The first design issued 57 SASS instructions
// per (sample, channel): its channel loop sat inside the sample loop, so
// every (sample, channel) reloaded the channel from shared memory,
// recomputed both ramps as 64-bit multiplies, divided T by 1023 and, in the
// walk, by 20 again. This design moves all of that out of the loop:
//   * channel-outer, samples in registers: thread t owns the samples
//     r = t + kThreads * k (k < kSamplesPerThread), so each warp covers 32
//     consecutive samples per k (coalesced stores, near-broadcast shared
//     loads), with both sums of every sample in registers; a channel's
//     state is read once per thread;
//   * phases stepped, not recomputed: base + t * step once per (thread,
//     channel), then one exact add of kThreads * step per sample. The code
//     phase's fraction is held shifted into the top 40 bits of 64, so the
//     add's carry-out is the chip carry (add.cc / addc: three
//     instructions); the carrier is held shifted by 24, so the table index
//     is the top 9 bits of its high word. The same uint64 values as
//     base + r * step: the sums stay below 2^52, nothing wraps;
//   * no division in the loop: the prologue lays each channel's signs (C/A
//     bit xor nav bit) out as one bit per chip, from the sub-block's first
//     chip on, across its code periods (sign_word). The loop indexes it by
//     the chip count since the first sample: no wrap at 1023, no nav walk;
//   * sign in the table index: a 1024-entry table of +-(cos, sin) pairs,
//     entry 2 * idx + sign, so the gain multiplies without a sign fix-up,
//     and the two signs of one idx sit in neighbouring banks;
//   * packing in the epilogue: one word (SC16, raw), one halfword (SC08,
//     planes) per sample and lane; SC01 ORs the bits of 16 lanes into a
//     word (__reduce_or_sync).
// The channel loop is kept rolled; its SASS length over kSamplesPerThread
// is what one (sample, channel) issues (chip_smoke.py phase 2 reads it with
// cuobjdump -sass): 18.6 in every instantiation with nvcc 12.9 (298 per
// trip), about 15 per sample and the rest the channel's per-thread setup,
// at 72 registers and no spills. One block per (sub-block, epoch),
// kThreads threads.
//
// Cost attribution (the ABLATE template value; the Pallas kernel's `ablate`
// argument, synth_pallas.py:84-97,371-435): each bit replaces one cost
// centre of the packed walk kernel with a stand-in of the same shape that
// keeps the work around it alive, so timing an ablated instantiation
// against the production one attributes the centre's time. Ablated
// kernels write wrong samples by design. Every instantiation in this file
// has ABLATE = 0; csrc/synth_profile.cu instantiates the others into a
// library of their own (built for tools/profile_kernel.py and
// tools/op_budget.py only), so this file's library and its SASS are those
// of the production loop.
// Domain: a channel's 2048 samples must span at most kSignWords * 32 chips,
// i.e. code steps below 2 chips per sample (the CLI's 1 Msps floor gives
// ~1.02); ops/synth.py refuses other wires on the host before they are
// uploaded, and the prologue traps on one that gets here anyway.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSubblock = 2048;  // gps_sdr_sim_tpu_torch.constants.SUBBLOCK
constexpr int kMaxChan = 16;     // gps_sdr_sim_tpu_torch.constants.MAX_CHAN
constexpr int kWireLanes = 12;   // gps_sdr_sim_tpu_torch.ops.plan.WIRE_LANES
constexpr int kRowLanes = 12;    // gps_sdr_sim_tpu_torch.ops.synth.ROW_LANES
// The schedule; ops/synth.py mirrors these (THREADS, SAMPLES_PER_THREAD,
// SIGN_WORDS, PERIODS) in its plain model of it, schedule_sums.
constexpr int kThreads = 128;
constexpr int kSamplesPerThread = kSubblock / kThreads;
constexpr int kSignWords = 128;  // sign bits per channel: 4096 chips
constexpr int kPeriods = 6;      // code periods the sign words can reach
constexpr int kCaLen = 1023;
constexpr uint64_t kMask40 = (uint64_t(1) << 40) - 1;
static_assert(kSubblock % kThreads == 0, "whole samples per thread");

// One channel of one block, as the prologue leaves it in shared memory.
struct Chan {
  uint64_t code_base;   // fraction of the code phase at sample 0, 2^-40 chip
  uint64_t code_step;   // code step bits [16, 64), 2^-40 chip per sample
  uint64_t carr_base;   // the same for the carrier (2^-40 cycle)
  uint64_t carr_step;
  uint64_t code_dfrac;  // (kThreads * code_step) << 24: one stride's fraction
  uint64_t carr_d;      // (kThreads * carr_step) << 24
  uint32_t code_dwhole; // (kThreads * code_step) >> 40: its whole chips
  int32_t gain;
  int32_t chip_first;   // chip of sample 0 in its code period Mfirst
  uint32_t navp;        // bit p: nav bit of code period Mfirst + p
  int32_t n_words;      // sign words the sub-block reads
  int32_t src;          // the channel's row of ca_words
};

// The ABLATE bits (ops/synth_cuda.py ABLATE_BITS):
//   kNoTrigGather: no trig[idx2] shared load; the stand-in cs = (idx2,
//     idx2) keeps the table index alive;
//   kNoCaGather: no sign-word load and no funnel shift; the stand-in sign
//     is bit 0 of the chip count;
//   kNoNavWalk: the prologue's sign words carry every nav bit as 0, so the
//     sign is the C/A bit alone. The nav rule runs in the prologue only,
//     so this removes the prologue's nav share, not a per-sample cost.
enum Ablate { kNoTrigGather = 1, kNoCaGather = 2, kNoNavWalk = 4 };

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

// The nav bit of code period M: the window walk, or lane M & 127 of the
// mask table (m0 >= 0 has 16 bits, so that division needs no floor fix-up).
template <bool NAV>
__device__ __forceinline__ uint32_t nav_bit(int M, int m0r, int m0, int b0,
                                            int navbits) {
  if constexpr (NAV) {
    int j = (m0 + int(uint32_t(M) & 127u)) / 20 - b0;
    j = j < 0 ? 0 : (j > 31 ? 31 : j);
    return uint32_t(navbits >> j) & 1u;
  } else {
    return uint32_t(shr_signfill(navbits, floor_div(m0r + M, 20))) & 1u;
  }
}

// Fill the fields that follow from the sub-block's phases: where its first
// chip lies, how many sign words it reads, the nav bit of each code period
// it can reach, and one stride of each phase.
template <bool NAV, int ABLATE>
__device__ __forceinline__ void finish_chan(Chan& p, int t_base, int m0r,
                                            int m0, int b0, int navbits) {
  const int m_first = floor_div(t_base, kCaLen);
  p.chip_first = t_base - kCaLen * m_first;
  const uint64_t span = (p.code_base + uint64_t(kSubblock - 1) * p.code_step)
                        >> 40;
  if (span >= uint64_t(kSignWords) * 32) __trap();  // outside the domain
  p.n_words = int(span >> 5) + 1;
  p.navp = 0;
  if constexpr ((ABLATE & kNoNavWalk) == 0) {
    for (int q = 0; q < kPeriods; ++q) {
      p.navp |= nav_bit<NAV>(m_first + q, m0r, m0, b0, navbits) << q;
    }
  }
  const uint64_t d = uint64_t(kThreads) * p.code_step;
  p.code_dfrac = d << 24;
  p.code_dwhole = uint32_t(d >> 40);
  p.carr_d = (uint64_t(kThreads) * p.carr_step) << 24;
}

// Sign word k of channel p: bit j is C/A bit xor nav bit of the chip
// chip_first + 32 k + j chips after the start of code period Mfirst, which
// lies in period Mfirst + (that / 1023). A word crosses at most one period
// end; chips past it restart at chip 0 of the next period.
__device__ __forceinline__ uint32_t sign_word(const Chan& p,
                                              const int32_t* ca, int k) {
  const uint32_t pos = uint32_t(p.chip_first) + 32u * uint32_t(k);
  const uint32_t period = pos / kCaLen;
  const uint32_t chip = pos - kCaLen * period;
  const uint32_t a = chip >> 5;
  uint32_t w = __funnelshift_r(uint32_t(ca[a]), uint32_t(ca[(a + 1) & 31]),
                               chip);
  w ^= 0u - ((p.navp >> period) & 1u);
  const uint32_t left = kCaLen - chip;  // chips left in this period
  if (left < 32) {
    const uint32_t low = (1u << left) - 1u;
    const uint32_t next = (uint32_t(ca[0]) << left) ^
                          (0u - ((p.navp >> (period + 1)) & 1u));
    w = (w & low) | (next & ~low);
  }
  return w;
}

// (acc + 64) >> 7, arithmetic, before the int16 wrap.
__device__ __forceinline__ int32_t quantize(uint32_t acc) {
  return int32_t(acc + 64u) >> 7;
}

__device__ __forceinline__ int32_t wrap16(int32_t v) { return int16_t(v); }

enum Mode { kPacked = 0, kPlanes = 1, kRaw = 2 };

// Channel c of the block (c < n_chan; one thread each): its parameters
// rebased to sub-block sb (wire) or read from its row, into *p. Returns
// whether its gain is not 0.
template <bool NAV, bool ROWS, int ABLATE>
__device__ __forceinline__ bool load_chan(const int32_t* __restrict__ params,
                                          int param_chans, int sb, int b,
                                          int sub_blocks, int c, Chan* p) {
  if constexpr (ROWS) {
    const int32_t* w =
        params + ((size_t(b) * sub_blocks + sb) * param_chans + c) * kRowLanes;
    p->gain = w[11];
    if (p->gain == 0) return false;
    p->code_base = lanes_u64(w, 0);
    p->code_step = lanes_u64(w, 2);
    p->carr_base = lanes_u64(w, 4);
    p->carr_step = lanes_u64(w, 6);
    finish_chan<false, ABLATE>(*p, w[8], w[9], 0, 0, w[10]);
  } else {
    const int32_t* w = params + (size_t(b) * param_chans + c) * kWireLanes;
    p->gain = w[11];
    if (p->gain == 0) return false;
    const uint64_t k0 = uint64_t(sb) * kSubblock;
    uint32_t carry;
    {
      uint64_t f = lanes_u64(w, 0), s = lanes_u64(w, 2);
      uint64_t lo = (f & 0xFFFF) + k0 * (s & 0xFFFF);
      uint64_t hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16);
      p->code_base = hi & kMask40;
      p->code_step = s >> 16;
      carry = uint32_t(hi >> 40);
    }
    {
      uint64_t f = lanes_u64(w, 4), s = lanes_u64(w, 6);
      uint64_t lo = (f & 0xFFFF) + k0 * (s & 0xFFFF);
      uint64_t hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16);
      p->carr_base = hi & kMask40;
      p->carr_step = s >> 16;
    }
    const int32_t m0 = w[9] & 0xFFFF, b0 = w[9] >> 16;
    finish_chan<NAV, ABLATE>(*p, int32_t(uint32_t(w[8]) + carry),
                             m0 - 20 * b0, m0, b0, w[10]);
  }
  p->src = c;
  return true;
}

// One block: sub-block blockIdx.x of epoch blockIdx.y. ROWS: `params` are
// the [B, SB, param_chans, 12] rows and every channel is summed; else the
// [B, param_chans, 12] wire, of which the first n_chan channels are summed.
// Channels whose gain is 0 add exactly 0 and are skipped. out: the packed
// words (kPacked) or the I plane; out_q: the Q plane (kPlanes, kRaw; unused
// for kPacked). ABLATE: 0, or the cost centres replaced (Ablate).
template <int MODE, int FMT, bool NAV, bool ROWS, int ABLATE = 0>
__device__ __forceinline__ void synth_block(
    const int32_t* __restrict__ params, const int32_t* __restrict__ ca_words,
    const int32_t* __restrict__ table, int32_t* __restrict__ out,
    int32_t* __restrict__ out_q, int param_chans, int n_chan) {
  // Entry 2 i + s: (cos i, sin i), negated when s = 1.
  __shared__ int2 trig[1024];
  __shared__ uint32_t signs[kMaxChan * kSignWords];
  __shared__ Chan ch[kMaxChan];
  __shared__ int n_live;

  const int sb = blockIdx.x;
  const int b = blockIdx.y;
  const int sub_blocks = gridDim.x;
  const uint32_t t = threadIdx.x;

  for (int i = t; i < 512; i += kThreads) {
    const int32_t c = table[512 + i], s = table[i];
    trig[2 * i] = make_int2(c, s);
    trig[2 * i + 1] = make_int2(-c, -s);
  }
  // Warp 0: one lane per channel; the live channels are packed first by a
  // ballot (n_chan <= 16).
  if (t < 32) {
    Chan p;
    const bool live = int(t) < n_chan &&
        load_chan<NAV, ROWS, ABLATE>(params, param_chans, sb, b, sub_blocks,
                                     t, &p);
    const uint32_t kept = __ballot_sync(0xFFFFFFFFu, live);
    if (live) ch[__popc(kept & ((1u << t) - 1u))] = p;
    if (t == 0) n_live = __popc(kept);
  }
  __syncthreads();
  const int live = n_live;
  // Warp w builds the sign words of channels w, w + 4, ...
  for (int c = t >> 5; c < live; c += kThreads / 32) {
    for (int k = t & 31; k < ch[c].n_words; k += 32) {
      signs[c * kSignWords + k] =
          sign_word(ch[c], ca_words + ch[c].src * 32, k);
    }
  }
  __syncthreads();

  uint32_t iacc[kSamplesPerThread], qacc[kSamplesPerThread];
#pragma unroll
  for (int k = 0; k < kSamplesPerThread; ++k) iacc[k] = qacc[k] = 0;

#pragma unroll 1
  for (int c = 0; c < live; ++c) {
    const Chan& p = ch[c];
    const uint64_t code = p.code_base + uint64_t(t) * p.code_step;
    uint32_t chips = uint32_t(code >> 40);  // since the sub-block's first
    const uint64_t frac = code << 24;
    uint32_t f_lo = uint32_t(frac), f_hi = uint32_t(frac >> 32);
    const uint32_t d_lo = uint32_t(p.code_dfrac);
    const uint32_t d_hi = uint32_t(p.code_dfrac >> 32);
    const uint32_t d_whole = p.code_dwhole;
    uint64_t carr = (p.carr_base + uint64_t(t) * p.carr_step) << 24;
    const uint64_t carr_d = p.carr_d;
    const uint32_t gain = uint32_t(p.gain);
    const uint32_t* sg = signs + c * kSignWords;
#pragma unroll
    for (int k = 0; k < kSamplesPerThread; ++k) {
      if (k > 0) {
        asm("add.cc.u32 %0, %0, %3;\n\t"
            "addc.cc.u32 %1, %1, %4;\n\t"
            "addc.u32 %2, %2, %5;"
            : "+r"(f_lo), "+r"(f_hi), "+r"(chips)
            : "r"(d_lo), "r"(d_hi), "r"(d_whole));
        carr += carr_d;
      }
      uint32_t sign;  // bit 0
      if constexpr ((ABLATE & kNoCaGather) != 0) {
        sign = chips;  // stand-in
      } else {
        const uint32_t w = sg[chips >> 5];
        sign = __funnelshift_r(w, w, chips);
      }
      const uint32_t idx2 = ((uint32_t(carr >> 32) >> 22) & ~1u) |
                            (sign & 1u);
      int2 cs;
      if constexpr ((ABLATE & kNoTrigGather) != 0) {
        cs = make_int2(int(idx2), int(idx2));  // stand-in
      } else {
        cs = trig[idx2];
      }
      iacc[k] += gain * uint32_t(cs.x);
      qacc[k] += gain * uint32_t(cs.y);
    }
  }

  const size_t row = size_t(b) * sub_blocks + sb;
#pragma unroll
  for (int k = 0; k < kSamplesPerThread; ++k) {
    const uint32_t r = t + kThreads * k;
    const size_t at = row * kSubblock + r;  // this sample, in samples
    if constexpr (MODE == kRaw) {
      out[at] = int32_t(iacc[k]);
      out_q[at] = int32_t(qacc[k]);
    } else {
      const int32_t iv = quantize(iacc[k]), qv = quantize(qacc[k]);
      if constexpr (MODE == kPlanes) {
        reinterpret_cast<int16_t*>(out)[at] = int16_t(iv);
        reinterpret_cast<int16_t*>(out_q)[at] = int16_t(qv);
      } else if constexpr (FMT == 16) {
        out[at] = int32_t((uint32_t(iv) & 0xFFFFu) | (uint32_t(qv) << 16));
      } else if constexpr (FMT == 8) {
        // Little-endian: sample r's byte pair is halfword r of the row.
        reinterpret_cast<uint16_t*>(out)[at] =
            uint16_t((uint32_t(wrap16(iv) >> 4) & 0xFFu) |
                     ((uint32_t(wrap16(qv) >> 4) & 0xFFu) << 8));
      } else {
        // 32 consecutive samples per warp, two words: each lane places its
        // two bits (its sample is sample lane & 15 of its word), an OR over
        // each half of the warp gathers them, lane 0 writes the word of the
        // first 16 samples and lane 1 the next.
        const uint32_t lane = t & 31u;
        const uint32_t bit_i = 8 * ((lane & 15) >> 2) + 7 - 2 * (lane & 3);
        const uint32_t first_half = lane < 16 ? ~0u : 0u;
        const uint32_t bits = (uint32_t(wrap16(iv) > 0) << bit_i) |
                              (uint32_t(wrap16(qv) > 0) << (bit_i - 1));
        const uint32_t w0 = __reduce_or_sync(0xFFFFFFFFu, bits & first_half);
        const uint32_t w1 = __reduce_or_sync(0xFFFFFFFFu, bits & ~first_half);
        if (lane < 2) out[(at - lane) / 16 + lane] = int32_t(lane ? w1 : w0);
      }
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

// csrc/synth_profile.cu includes this file for its kernels and defines
// entry points of its own.
#ifndef SYNTH_NO_ENTRY_POINTS

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

#endif  // SYNTH_NO_ENTRY_POINTS
