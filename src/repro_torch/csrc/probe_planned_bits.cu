// probe_planned_bits: the flat Bloom filter's planned bit probe.
//
// Replaces the TPU kernel repro/kernels/idl_probe/kernel.py::probe_runs
// (body _probe_kernel) together with the probe-order scatter of
// repro/kernels/idl_probe/ops.py::scatter_and_reduce. For each run r of a
// ProbePlan over bit locations and each valid lane c (offset o >= 0), it
// writes bit (o & 31) of word block_ids[r] * block_words + (o >> 5) of the
// packed filter to out[probe_index[r, c]]. The result is the (n_probes,)
// bits in probe order; the AND over the eta repetitions stays in torch, as
// the reference keeps it outside its kernel. Every probe index appears in
// exactly one valid lane, so the output needs no initialisation and pad
// lanes write nothing (the TPU kernel's "pad lanes read 1" is not needed).
//
// What bounds it on an H100: bytes, and the latency of scattered 4-byte
// reads. A 256-read batch makes 204,800 probes into a 512 MiB filter, ten
// times the L2; each probe needs one 32-byte sector of the filter, and the
// plan's offsets and probe indices one sector per eight valid lanes.
//
// What the design does about it: one warp per run. Pad lanes trail the
// valid ones in every run (the planner fills a run from lane 0), so the warp
// reads the run's first 8 offsets (one sector), then 32 at a time, and stops
// at the first step that holds a pad lane (a ballot); the padding is never
// read. Each lane loads its one word straight from device memory. No tile
// is staged in shared memory: the block is L bits (4 KiB, 128 sectors at
// L = 2^15) and a run holds at most C = 128 probes, so staging the block
// never reads less than the probes do; probes of one run that share a
// sector meet in L1 and L2. Word offsets are 64-bit: at m = 2^32 the filter
// has 2^27 words.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kFirstSpan = 8;  // lanes of a run's first step: one sector
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
probe_planned_bits_kernel(const unsigned* __restrict__ bf_words,
                          const int32_t* __restrict__ block_ids,
                          const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ probe_index,
                          int32_t* __restrict__ out, int n_runs,
                          int probes_per_run, int64_t block_words) {
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= n_runs) return;  // the whole warp leaves together
  const unsigned* block =
      bf_words + static_cast<int64_t>(block_ids[run]) * block_words;
  const int64_t first = static_cast<int64_t>(run) * probes_per_run;
  // steps of 8, then 24, then 32 lanes: each after the first is aligned
  for (int c0 = 0, span = kFirstSpan; c0 < probes_per_run;
       c0 += span, span = 32 - (c0 & 31)) {
    const int c = c0 + lane;
    const int off =
        lane < span && c < probes_per_run ? offsets[first + c] : -1;
    if (off >= 0)
      out[probe_index[first + c]] =
          static_cast<int32_t>((block[off >> 5] >> (off & 31)) & 1u);
    // a pad lane (or the run's end) in this step: nothing valid follows
    if (__ballot_sync(kFullMask, off >= 0) !=
        (span == 32 ? kFullMask : (1u << span) - 1u))
      break;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_planned_bits(const void* bf_words, const void* block_ids,
                                  const void* offsets,
                                  const void* probe_index, void* out,
                                  int n_runs, int probes_per_run,
                                  long long block_words, void* stream) {
  if (n_runs > 0) {
    const int blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_planned_bits_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(bf_words),
        static_cast<const int32_t*>(block_ids),
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(probe_index),
        static_cast<int32_t*>(out), n_runs, probes_per_run,
        static_cast<int64_t>(block_words));
  }
  return static_cast<int>(cudaGetLastError());
}
