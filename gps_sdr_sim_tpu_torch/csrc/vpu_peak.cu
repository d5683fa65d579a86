// Int32 throughput microbenchmark for NVIDIA Hopper (sm_90a).
//
// Replaces tools/vpu_peak.py: the Pallas kernel `_make_kernel` (:58), run by
// `_run_case` (:119, pallas_call :127). Each element of a (16, 128) int32
// seed block, repeated over `tiles`, runs `rounds` rounds of 8 dependent
// chains seeded from runtime data: per round, ALU ops alternating
// add / xor-shift (each reading another live chain), GATHERS lookups of a
// 128-entry table, and N_EXTRA multiplies (kImul) or float32 round trips
// (kF32rt: the convert, + 0.5, * 1/1023, floor, convert pattern of a floor
// division done in float). The output is the xor of the chains, so nothing
// can be folded away. The five cases of tools/vpu_peak.py:184-193:
//   alu   <32, 0, kNone, 0>   gather <32, 4, kNone, 0>   mix <38, 2, kNone, 0>
//   imul  <32, 0, kImul, 4>   f32rt  <32, 0, kF32rt, 4>
//
// What it measures: the SM's integer issue rate in the synthesis kernel's
// op mix. One thread per element; the gather is a lookup in a 128-entry
// __shared__ table, Hopper's counterpart of the TPU's lane gather and what
// the synthesis kernel's C/A, sin/cos and nav-table lookups are. The round
// loop is kept rolled so that its SASS length (chip_smoke.py counts it with
// cuobjdump -sass) is the instructions of one round: IADD3 and LOP3 fuse
// source ops, so instructions per round and source ops per round differ.
//
// The chains are uint32_t (signed overflow is undefined in C++, and the add
// and multiply chains overflow by design); the >> 1 is arithmetic, through
// an explicit int32_t cast, as on the TPU's int32 lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 16 * 128;  // elements of the seed block
constexpr int kChains = 8;
constexpr int kThreads = 256;

enum Extra { kNone = 0, kImul = 1, kF32rt = 2 };

template <int ALU, int GATHERS, int EXTRA, int N_EXTRA>
__global__ void __launch_bounds__(kThreads)
vpu_peak_kernel(const int32_t* __restrict__ seed,
                const int32_t* __restrict__ table, int32_t* __restrict__ out,
                int n, int rounds) {
  __shared__ int32_t tbl[128];
  if (threadIdx.x < 128) tbl[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const uint32_t s = uint32_t(seed[e % kSlab]);
  uint32_t acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c] = s + uint32_t(c);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < ALU; ++j) {
      const int c = j % kChains;
      if ((j / kChains) % 2 == 0) {
        acc[c] += acc[(c + 3) % kChains];
      } else {
        acc[c] ^= uint32_t(int32_t(acc[(c + 1) % kChains]) >> 1);
      }
    }
#pragma unroll
    for (int j = 0; j < GATHERS; ++j) {
      const int c = (j + 1) % kChains;
      acc[c] += uint32_t(tbl[acc[c] & 127u]);
    }
#pragma unroll
    for (int j = 0; j < N_EXTRA; ++j) {
      const int c = (j + 5) % kChains;
      if constexpr (EXTRA == kImul) {
        acc[c] *= acc[(c + 3) % kChains];
      } else if constexpr (EXTRA == kF32rt) {
        // float32(1/1023) = 0x3a802008, the constant of tools/vpu_peak.py.
        const float t = float(int32_t(acc[(c + 3) % kChains] & 0xFFFFFu));
        acc[c] += uint32_t(int32_t(floorf((t + 0.5f) * 0x1.004010p-10f)));
      }
    }
  }
  uint32_t o = acc[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) o ^= acc[c];
  out[e] = int32_t(o);
}

template <int ALU, int GATHERS, int EXTRA, int N_EXTRA>
int launch(const int32_t* seed, const int32_t* table, int32_t* out, int n,
           int rounds, void* stream) {
  vpu_peak_kernel<ALU, GATHERS, EXTRA, N_EXTRA>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(seed, table, out, n, rounds);
  return int(cudaGetLastError());
}

}  // namespace

// Launch case `kind` (0 alu, 1 gather, 2 mix, 3 imul, 4 f32rt) on `stream`
// and return cudaGetLastError() (0 on success). seed [16, 128] int32,
// table [128] int32, out [tiles * 16, 128] int32.
extern "C" int vpu_peak_launch(const int32_t* seed, const int32_t* table,
                               int32_t* out, int tiles, int rounds, int kind,
                               void* stream) {
  if (tiles < 1 || tiles > (1 << 20) / 2 || rounds < 0) {
    return int(cudaErrorInvalidValue);
  }
  const int n = tiles * kSlab;
  switch (kind) {
    case 0:
      return launch<32, 0, kNone, 0>(seed, table, out, n, rounds, stream);
    case 1:
      return launch<32, 4, kNone, 0>(seed, table, out, n, rounds, stream);
    case 2:
      return launch<38, 2, kNone, 0>(seed, table, out, n, rounds, stream);
    case 3:
      return launch<32, 0, kImul, 4>(seed, table, out, n, rounds, stream);
    case 4:
      return launch<32, 0, kF32rt, 4>(seed, table, out, n, rounds, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
