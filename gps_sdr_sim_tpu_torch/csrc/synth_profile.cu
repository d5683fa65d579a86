// Ablated instantiations of the synthesis kernel's packed walk mode, for
// cost attribution only (tools/profile_kernel.py times them against the
// production kernel; tools/op_budget.py counts their SASS).
//
// Counterpart of the `ablate` argument of the Pallas kernel
// (gps_sdr_sim_tpu/ops/synth_pallas.py:_make_kernel, :84-97,175,371-435):
// csrc/synth.cu's synth_block with an ABLATE mask other than 0 (its Ablate
// bits: kNoTrigGather, kNoCaGather, kNoNavWalk), for SC16, SC08 and SC01,
// in four sets: each bit alone and the two gathers together (no_gathers).
// Every ablated kernel writes wrong samples by design; ops/synth.py
// schedule_sums(ablate=...) is the plain version each must equal word for
// word. This file is built into a library of its own, so the production
// library (csrc/synth.cu alone) keeps its instantiations and its SASS.

#define SYNTH_NO_ENTRY_POINTS
#include "synth.cu"

namespace {

template <int FMT, int ABLATE>
__global__ void __launch_bounds__(kThreads)
synth_profile_kernel(const int32_t* __restrict__ wire,
                     const int32_t* __restrict__ ca_words,
                     const int32_t* __restrict__ table,
                     int32_t* __restrict__ out, int wire_chans, int n_chan) {
  synth_block<kPacked, FMT, false, false, ABLATE>(
      wire, ca_words, table, out, nullptr, wire_chans, n_chan);
}

template <int FMT, int ABLATE>
int launch_profile(const int32_t* wire, const int32_t* ca_words,
                   const int32_t* table, int32_t* out, int n_epochs,
                   int wire_chans, int n_chan, int sub_blocks,
                   cudaStream_t stream) {
  dim3 grid(sub_blocks, n_epochs);
  synth_profile_kernel<FMT, ABLATE><<<grid, kThreads, 0, stream>>>(
      wire, ca_words, table, out, wire_chans, n_chan);
  return int(cudaGetLastError());
}

template <int FMT>
int launch_set(const int32_t* wire, const int32_t* ca_words,
               const int32_t* table, int32_t* out, int n_epochs,
               int wire_chans, int n_chan, int sub_blocks, int ablate,
               cudaStream_t stream) {
  switch (ablate) {
    case kNoTrigGather:
      return launch_profile<FMT, kNoTrigGather>(
          wire, ca_words, table, out, n_epochs, wire_chans, n_chan,
          sub_blocks, stream);
    case kNoCaGather:
      return launch_profile<FMT, kNoCaGather>(
          wire, ca_words, table, out, n_epochs, wire_chans, n_chan,
          sub_blocks, stream);
    case kNoNavWalk:
      return launch_profile<FMT, kNoNavWalk>(
          wire, ca_words, table, out, n_epochs, wire_chans, n_chan,
          sub_blocks, stream);
    case kNoTrigGather | kNoCaGather:
      return launch_profile<FMT, kNoTrigGather | kNoCaGather>(
          wire, ca_words, table, out, n_epochs, wire_chans, n_chan,
          sub_blocks, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch the ablated packed walk kernel on `stream` and return
// cudaGetLastError() (0 on success). Arguments as synth_wire_launch's,
// with `ablate` one of the four sets (a mask of Ablate bits); any other
// mask, 0 included, is refused: the production kernel is synth.cu's.
extern "C" int synth_profile_launch(const int32_t* wire,
                                    const int32_t* ca_words,
                                    const int32_t* table, int32_t* out,
                                    int n_epochs, int wire_chans, int n_chan,
                                    int sub_blocks, int fmt, int ablate,
                                    void* stream) {
  if (bad_shape(n_epochs, wire_chans, n_chan, sub_blocks)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 16:
      return launch_set<16>(wire, ca_words, table, out, n_epochs, wire_chans,
                            n_chan, sub_blocks, ablate, st);
    case 8:
      return launch_set<8>(wire, ca_words, table, out, n_epochs, wire_chans,
                           n_chan, sub_blocks, ablate, st);
    case 1:
      return launch_set<1>(wire, ca_words, table, out, n_epochs, wire_chans,
                           n_chan, sub_blocks, ablate, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
