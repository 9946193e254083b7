// probe_planned_bits: the flat Bloom filter's bit probe with the AND over
// eta.
//
// Replaces the TPU kernel repro/kernels/idl_probe/kernel.py::probe_runs
// (body _probe_kernel) together with what the reference does after it: the
// probe-order scatter and AND over eta of repro/kernels/idl_probe/ops.py::
// scatter_and_reduce, and, on the flat filter's query plan, the bit
// extraction and AND of repro/index/query.py::_finish_probe. For every key
// (b, k) of a (B, eta, n_k) int64 tensor of bit locations over a packed
// (n_rows, W) int32 matrix (W = 1: the flat filter's words) it writes
// out[b, k, w] = AND over e of bit (loc & 31) of word w of row loc >> 5,
// where loc = locs[b, e, k]: one {0, 1} int32 per key and word. No run
// plan, pad lane or probe index reaches it.
//
// What bounds it on an H100: bytes, and the latency of scattered 4-byte
// reads. A 256-read batch makes 204,800 probes into a 512 MiB filter, ten
// times the L2: each probe needs one 32-byte sector of the filter (fewer
// when probes share one), each location 8 bytes and each key's answer 4.
//
// What the design does about it: one thread per key, grid-strided, its eta
// location loads issued together and then its eta word loads, all
// independent (unrolled by four). Threads follow key order, so the
// neighbouring k-mers of one read sit in neighbouring lanes, and their
// locations are one coalesced load per repetition. That is the design's
// reason: IDL puts a read's neighbouring k-mers in one L-bit window (8.21
// probes per 4 KiB block on the flat IDL plans), so the lanes of one warp
// load instruction land in few sectors and the card merges them, where the
// TPU needed a run plan to bring that block in once. No tile is staged in
// shared memory: a warp's probes of one block touch a few of its 128
// sectors. Word offsets are 64-bit: at m = 2^32 the filter has 2^27 words.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 4;  // repetitions whose loads are in flight together

__global__ void __launch_bounds__(kThreads)
probe_bits_kernel(const unsigned* __restrict__ words,
                  const long long* __restrict__ locs, int32_t* __restrict__ out,
                  long long n_keys, int n_k, int eta, int row_words) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long key = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       key < n_keys; key += stride) {
    const long long* loc = locs + (key / n_k) * eta * n_k + key % n_k;
    for (int w = 0; w < row_words; ++w) {  // one word on the flat filter
      unsigned acc = 1u;
      for (int e0 = 0; e0 < eta; e0 += kStep) {
        long long l[kStep];
        unsigned v[kStep];
#pragma unroll
        for (int i = 0; i < kStep; ++i)
          l[i] = e0 + i < eta ? __ldg(loc + static_cast<long long>(e0 + i) *
                                                n_k)
                              : -1;
#pragma unroll
        for (int i = 0; i < kStep; ++i)
          v[i] = l[i] >= 0
                     ? __ldg(words + (l[i] >> 5) * row_words + w) >> (l[i] & 31)
                     : 1u;
#pragma unroll
        for (int i = 0; i < kStep; ++i) acc &= v[i];
      }
      out[key * row_words + w] = static_cast<int32_t>(acc & 1u);
    }
  }
}

// Blocks that fill the card once (every SM at its occupancy), for the
// grid-stride loop; computed once.
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_bits_kernel,
                                                  kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

}  // namespace

// out[b, k, w] = AND over e of bit locs[b, e, k] & 31 of word w of row
// locs[b, e, k] >> 5, for the n_keys = B * n_k keys. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int probe_planned_bits(const void* words, const void* locs,
                                  void* out, long long n_keys, int n_k,
                                  int eta, int row_words, void* stream) {
  if (n_keys > 0) {
    const long long wanted = (n_keys + kThreads - 1) / kThreads;
    const long long cap = resident_blocks();
    const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
    probe_bits_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(words),
        static_cast<const long long*>(locs), static_cast<int32_t*>(out),
        n_keys, n_k, eta, row_words);
  }
  return static_cast<int>(cudaGetLastError());
}
