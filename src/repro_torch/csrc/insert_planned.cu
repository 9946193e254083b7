// insert_planned: the ingest side's scatter-OR of single bits, in place.
//
// Replaces the TPU kernels repro/kernels/idl_insert/kernel.py::insert_runs
// (body _insert_runs_kernel, with its tile write-back
// ref.py::apply_tiles_to_matrix) and ::insert_round (with
// ref.py::apply_insert_to_words). For every position p >= 0 of a 1-D int64
// array it sets bit (p & 31) of word p >> 5 of the packed int32 words,
// viewed flat: a bit-sliced (n_rows, W) matrix at (row * W + word) * 32 +
// bit, or a flat filter at its bit location. Negative positions (masked
// targets, a plan's pad lanes) are skipped.
//
// What bounds it on an H100: bytes, and the latency of scattered
// read-modify-writes. A 512-read batch of the bit-sliced index sets ~410k
// bits over 2^31 words (8 GiB, 160 times the L2), almost all in distinct
// words: each bit costs one 32-byte sector read and written, and its
// position 8 bytes read once.
//
// What the design does about it: one thread per position of a compact
// operand, with no run plan, pad lanes or tiles (a run plan's valid lanes
// are flattened into positions on the device by the caller). The TPU needed
// a plan to bring 64 KiB tiles into VMEM, one block id per grid step, and
// wrote whole tiles back; an atomicOr into device memory needs neither a
// tile nor an order. On the main path the positions arrive sorted and
// unique (the caller's torch.unique), so the bits of one word are adjacent:
// a thread whose predecessor names another word leads its word, ORs the
// masks of the followers after it, and issues one atomicOr whose result is
// unused (a fire-and-forget reduction); a follower issues nothing.
// Neighbours' positions come from warp shuffles, so a thread loads one
// position, and only lanes 0 and 31 load one more. The kernel stays right
// for any order and for duplicates: every maximal stretch of adjacent
// same-word positions has exactly one leader, and the OR is atomic because
// two leaders (unsorted input) or two launches can still touch one word.
// Word offsets are 64-bit: bit-sliced positions reach 2^36.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
insert_planned_kernel(unsigned* __restrict__ words,
                      const long long* __restrict__ pos, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long p = i < n ? pos[i] : -1;
  // the neighbours' positions, from the warp or (at its edges) memory;
  // every lane takes part in both shuffles
  long long prev = __shfl_up_sync(kFullMask, p, 1);
  long long next = __shfl_down_sync(kFullMask, p, 1);
  if (lane == 0) prev = i > 0 && i <= n ? pos[i - 1] : -1;
  if (lane == 31) next = i + 1 < n ? pos[i + 1] : -1;
  // a negative position names a negative word, never a real one
  const long long word = p >> 5;
  if (p < 0 || (prev >> 5) == word) return;  // skipped, or a follower
  unsigned mask = 1u << static_cast<unsigned>(p & 31);
  for (long long j = i + 1; (next >> 5) == word;) {  // next == pos[j]
    mask |= 1u << static_cast<unsigned>(next & 31);
    if (++j >= n) break;
    next = pos[j];
  }
  atomicOr(words + word, mask);
}

}  // namespace

// Sets the bits of n flat int64 positions in the int32 words, on `stream`;
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// count the grid cannot cover. The caller has checked that every position
// lies inside the words.
extern "C" int insert_planned(void* words, const void* positions,
                              long long n, void* stream) {
  if (n < 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    insert_planned_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned*>(words),
        static_cast<const long long*>(positions), n);
  }
  return static_cast<int>(cudaGetLastError());
}
