// gather_planned_rows: the query side's planned row gather.
//
// Replaces the TPU kernel repro/kernels/idl_probe/kernel.py::probe_rows
// (body _probe_rows_kernel) together with the gather_index realignment of
// repro/kernels/idl_probe/ops.py::_planned_gather. For each run r of a
// ProbePlan and each valid lane c (offset >= 0), it copies matrix row
// block_ids[r] * rows_per_block + offsets[r, c] into out[probe_index[r, c]].
// The result is the (n_probes, W) rows in probe order; the TPU kernel's
// (R_pad, C, W) intermediate, pad lanes included, is never materialised.
//
// What bounds it on an H100: bytes. Each probe moves one W-word row (128 B
// at W = 32) from a random place of a matrix far larger than L2. The plan
// pads every run to C lanes with -1, but a run holds about one probe at the
// full configuration, so the offsets the work needs are one 32-byte sector
// per run. There is no arithmetic to speak of.
//
// What the design does about it: one warp per run. Pad lanes trail the
// valid ones in every run (the planner fills a run from lane 0), so the warp
// reads the run's first 8 offsets (one sector), then 32 at a time, and stops
// at the first step that holds a pad lane (a ballot); the padded rest of the
// run is never read. Each valid probe's row goes straight from device
// memory to its probe-order slot: W words strided over the lanes (one
// coalesced 128-byte row at W = 32); at W = 1 every lane copies its own
// probe. No tile is staged in
// shared memory: at the full configuration (L = 2^17 rows, 512-row runs) a
// run holds about one probe, and staging its 64 KiB tile would move 64 KiB
// to use 128 bytes; any reuse across runs is left to L2. Row offsets are
// 64-bit: 2^26 rows x 32 words is 2^31 words.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kFirstSpan = 8;  // lanes of a run's first step: one sector
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_planned_rows_kernel(const int32_t* __restrict__ matrix,
                           const int32_t* __restrict__ block_ids,
                           const int32_t* __restrict__ offsets,
                           const int32_t* __restrict__ probe_index,
                           int32_t* __restrict__ out, int n_runs,
                           int probes_per_run, int rows_per_block,
                           int row_words) {
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= n_runs) return;  // the whole warp leaves together
  const int64_t base_row =
      static_cast<int64_t>(block_ids[run]) * rows_per_block;
  const int64_t first = static_cast<int64_t>(run) * probes_per_run;
  // steps of 8, then 24, then 32 lanes: each after the first is aligned
  for (int c0 = 0, span = kFirstSpan; c0 < probes_per_run;
       c0 += span, span = 32 - (c0 & 31)) {
    const int c = c0 + lane;
    const int off =
        lane < span && c < probes_per_run ? offsets[first + c] : -1;
    const bool valid = off >= 0;
    const int dst = valid ? probe_index[first + c] : 0;
    const unsigned step = __ballot_sync(kFullMask, valid);
    if (row_words == 1) {
      if (valid) out[dst] = matrix[base_row + off];
    } else {
      for (unsigned todo = step; todo; todo &= todo - 1) {
        const int src = __ffs(todo) - 1;
        const int o = __shfl_sync(kFullMask, off, src);
        const int d = __shfl_sync(kFullMask, dst, src);
        const int32_t* from = matrix + (base_row + o) * row_words;
        int32_t* to = out + static_cast<int64_t>(d) * row_words;
        for (int w = lane; w < row_words; w += 32) to[w] = from[w];
      }
    }
    // a pad lane (or the run's end) in this step: nothing valid follows
    if (step != (span == 32 ? kFullMask : (1u << span) - 1u)) break;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int gather_planned_rows(const void* matrix, const void* block_ids,
                                   const void* offsets,
                                   const void* probe_index, void* out,
                                   int n_runs, int probes_per_run,
                                   int rows_per_block, int row_words,
                                   void* stream) {
  if (n_runs > 0) {
    const int blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    gather_planned_rows_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(matrix),
        static_cast<const int32_t*>(block_ids),
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(probe_index),
        static_cast<int32_t*>(out), n_runs, probes_per_run, rows_per_block,
        row_words);
  }
  return static_cast<int>(cudaGetLastError());
}
