// insert_planned: the ingest side's planned scatter-OR, in place.
//
// Replaces the TPU kernel repro/kernels/idl_insert/kernel.py::insert_runs
// (body _insert_runs_kernel, helper _bit_image) together with the tile
// write-back repro/kernels/idl_insert/ref.py::apply_tiles_to_matrix. For
// each run r of an InsertRunPlan and each valid lane c (offset o >= 0), it
// sets bit (o & 31) of word block_ids[r] * rows_per_block * W + (o >> 5)
// of the packed (n_rows, W) matrix.
//
// What bounds it on an H100: bytes, and the latency of scattered
// read-modify-writes. A 512-read batch sets ~370k bits spread over a matrix
// far larger than L2 (one 32-byte sector per bit, read and written); the
// plan pads every run to C lanes with -1, but a run holds about three bits,
// one 32-byte sector of offsets.
//
// What the design does about it: one warp per run. Pad lanes trail the
// valid ones in every run (the planner fills a run from lane 0), so the warp
// reads the run's first 8 offsets (one sector), then 32 at a time, and stops
// at the first step that holds a pad lane (a ballot). Each lane issues one
// atomicOr for a valid offset, so the only matrix traffic is the touched
// words. The caller passes only the true runs, not the pow2 pad runs. The
// TPU form does
// not carry over: it returns one 64 KiB tile per touched block (about the
// whole 8 GiB matrix at the full configuration) and relies on the grid
// running in order ("the first run of a slot initialises the tile"), while
// CUDA blocks run in no order. Offsets are unique after the planner's
// np.unique, but two lanes can still set different bits of one word, so
// the OR is atomic. Word offsets are 64-bit: 2^26 x 32 words is 2^31.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kFirstSpan = 8;  // lanes of a run's first step: one sector
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
insert_planned_kernel(unsigned* __restrict__ matrix,
                      const int32_t* __restrict__ block_ids,
                      const int32_t* __restrict__ offsets, int n_runs,
                      int inserts_per_run, int64_t block_words) {
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= n_runs) return;
  unsigned* tile = matrix + static_cast<int64_t>(block_ids[run]) * block_words;
  const int32_t* offs = offsets + static_cast<int64_t>(run) * inserts_per_run;
  // steps of 8, then 24, then 32 lanes: each after the first is aligned
  for (int c0 = 0, span = kFirstSpan; c0 < inserts_per_run;
       c0 += span, span = 32 - (c0 & 31)) {
    const int c = c0 + lane;
    const int o = lane < span && c < inserts_per_run ? offs[c] : -1;
    if (o >= 0) atomicOr(tile + (o >> 5), 1u << (o & 31));
    // a pad lane (or the run's end) in this step: nothing valid follows
    if (__ballot_sync(kFullMask, o >= 0) !=
        (span == 32 ? kFullMask : (1u << span) - 1u))
      break;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int insert_planned(void* matrix, const void* block_ids,
                              const void* offsets, int n_runs,
                              int inserts_per_run, long long block_words,
                              void* stream) {
  if (n_runs > 0) {
    const int blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    insert_planned_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned*>(matrix),
        static_cast<const int32_t*>(block_ids),
        static_cast<const int32_t*>(offsets), n_runs, inserts_per_run,
        static_cast<int64_t>(block_words));
  }
  return static_cast<int>(cudaGetLastError());
}
