// Fused GPS L1 C/A I/Q synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces gps_sdr_sim_tpu/ops/synth_pallas.py: the Pallas kernel
// `_make_kernel` (per-sample synthesis, summed over channels, quantized
// and packed into the final SC16/SC08/SC01 words) together with the XLA
// prologue `_wire_to_params` / `_device_rebase` / `_unpack_wire` (the exact
// per-sub-block phase rebase). The rebase runs here in the block prologue,
// so no per-sub-block parameter array ever reaches device memory.
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
// costs two 64-bit multiply-adds, two floor divisions, two shared-memory
// lookups (C/A word, sin/cos) and ~20 other integer ops; SC16 also writes
// 4 bytes per sample (3.1 GB for the 300 s canonical run), which at HBM
// rates is far below the ALU time. This first design is the simple one:
// one block per (sub-block, epoch), 128 threads, each thread writing 16
// samples' worth of output words, the 512-entry sin/cos table, the C/A
// words and the rebased channel parameters held in shared memory. It
// recomputes the ramps with multiplies instead of stepping them, and it
// does not specialise on the rate or the gain. Those are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSubblock = 2048;  // gps_sdr_sim_tpu.constants.SUBBLOCK
constexpr int kMaxChan = 16;     // gps_sdr_sim_tpu.constants.MAX_CHAN
constexpr int kWireLanes = 12;   // gps_sdr_sim_tpu.ops.plan.WIRE_LANES
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

__device__ __forceinline__ uint64_t wire_u64(const int32_t* w, int lane) {
  return uint64_t(uint32_t(w[lane])) | (uint64_t(uint32_t(w[lane + 1])) << 32);
}

// Quantized (I, Q) of in-sub-block sample r, before the int16 wrap.
__device__ __forceinline__ void sample_iq(int r, int n_chan, const Chan* ch,
                                          const uint32_t* ca,
                                          const int32_t* sin_t,
                                          const int32_t* cos_t, int32_t* i_out,
                                          int32_t* q_out) {
  uint32_t iacc = 0, qacc = 0;
  for (int c = 0; c < n_chan; ++c) {
    const Chan& p = ch[c];
    uint64_t code = p.code_base + uint64_t(r) * p.code_step;
    int T = int(uint32_t(p.t_base) + uint32_t(code >> 40));
    int M = floor_div(T, kCaLen);
    int chip = T - kCaLen * M;
    int ca_bit = (ca[c * 32 + (chip >> 5)] >> (chip & 31)) & 1;
    int j = floor_div(p.m0r + M, 20);
    int nav_bit = shr_signfill(p.navbits, j) & 1;
    uint64_t carr = p.carr_base + uint64_t(r) * p.carr_step;
    int idx = int(carr >> 31) & 0x1FF;
    uint32_t neg = 0u - uint32_t(ca_bit ^ nav_bit);  // 0 or all ones
    uint32_t vc = uint32_t(p.gain) * uint32_t(cos_t[idx]);
    uint32_t vs = uint32_t(p.gain) * uint32_t(sin_t[idx]);
    iacc += (vc ^ neg) - neg;
    qacc += (vs ^ neg) - neg;
  }
  *i_out = int32_t(iacc + 64u) >> 7;
  *q_out = int32_t(qacc + 64u) >> 7;
}

__device__ __forceinline__ int32_t wrap16(int32_t v) { return int16_t(v); }

template <int FMT>
__global__ void __launch_bounds__(kThreads)
synth_wire_kernel(const int32_t* __restrict__ wire,
                  const int32_t* __restrict__ ca_words,
                  const int32_t* __restrict__ table,
                  int32_t* __restrict__ out, int wire_chans, int n_chan) {
  constexpr int kDiv = FMT == 16 ? 1 : (FMT == 8 ? 2 : 16);
  constexpr int kWords = kSubblock / kDiv;  // output words per sub-block

  __shared__ int32_t sin_t[512];
  __shared__ int32_t cos_t[512];
  __shared__ uint32_t ca[kMaxChan * 32];
  __shared__ Chan ch[kMaxChan];

  const int sb = blockIdx.x;
  const int b = blockIdx.y;
  const int sub_blocks = gridDim.x;

  for (int i = threadIdx.x; i < 512; i += kThreads) {
    sin_t[i] = table[i];
    cos_t[i] = table[512 + i];
  }
  for (int i = threadIdx.x; i < n_chan * 32; i += kThreads) {
    ca[i] = uint32_t(ca_words[i]);
  }
  if (threadIdx.x < n_chan) {
    const int32_t* w =
        wire + (size_t(b) * wire_chans + threadIdx.x) * kWireLanes;
    const uint64_t k0 = uint64_t(sb) * kSubblock;
    Chan p;
    {
      uint64_t f = wire_u64(w, 0), s = wire_u64(w, 2);
      uint64_t lo = (f & 0xFFFF) + k0 * (s & 0xFFFF);
      uint64_t hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16);
      p.code_base = hi & kMask40;
      p.code_step = s >> 16;
      p.t_base = int32_t(uint32_t(w[8]) + uint32_t(hi >> 40));
    }
    {
      uint64_t f = wire_u64(w, 4), s = wire_u64(w, 6);
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
  __syncthreads();

  int32_t* o = out + (size_t(b) * sub_blocks + sb) * kWords;
  for (int wi = threadIdx.x; wi < kWords; wi += kThreads) {
    int32_t iv, qv;
    if (FMT == 16) {
      sample_iq(wi, n_chan, ch, ca, sin_t, cos_t, &iv, &qv);
      o[wi] = int32_t((uint32_t(iv) & 0xFFFFu) | (uint32_t(qv) << 16));
    } else if (FMT == 8) {
      uint32_t word = 0;
      for (int k = 0; k < 2; ++k) {
        sample_iq(2 * wi + k, n_chan, ch, ca, sin_t, cos_t, &iv, &qv);
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
        sample_iq(16 * wi + k, n_chan, ch, ca, sin_t, cos_t, &iv, &qv);
        int bit = 8 * (k >> 2) + 7 - 2 * (k & 3);
        word |= uint32_t(wrap16(iv) > 0) << bit;
        word |= uint32_t(wrap16(qv) > 0) << (bit - 1);
      }
      o[wi] = int32_t(word);
    }
  }
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success).
// wire [n_epochs, wire_chans, 12] int32, ca_words [wire_chans, 32] int32,
// table [2, 512] int32 (sin row, cos row),
// out [n_epochs, sub_blocks * 2048 / div] int32 with div = 1, 2, 16 for
// fmt = 16, 8, 1. Only the first n_chan channels are summed.
extern "C" int synth_wire_launch(const int32_t* wire, const int32_t* ca_words,
                                 const int32_t* table, int32_t* out,
                                 int n_epochs, int wire_chans, int n_chan,
                                 int sub_blocks, int fmt, void* stream) {
  if (n_chan < 1 || n_chan > kMaxChan || n_chan > wire_chans ||
      n_epochs < 1 || n_epochs > 65535 || sub_blocks < 1) {
    return int(cudaErrorInvalidValue);
  }
  dim3 grid(sub_blocks, n_epochs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 16:
      synth_wire_kernel<16><<<grid, kThreads, 0, s>>>(wire, ca_words, table,
                                                      out, wire_chans, n_chan);
      break;
    case 8:
      synth_wire_kernel<8><<<grid, kThreads, 0, s>>>(wire, ca_words, table,
                                                     out, wire_chans, n_chan);
      break;
    case 1:
      synth_wire_kernel<1><<<grid, kThreads, 0, s>>>(wire, ca_words, table,
                                                     out, wire_chans, n_chan);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
