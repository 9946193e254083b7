// rambo_merge_coverage: RAMBO's R-fold merge and coverage count in one pass.
//
// Replaces no TPU kernel: the JAX package merges with jnp (repro/index/
// engines.py RamboIndex.query_batch gathers each repetition's bucket column
// and ANDs them, repro/index/query.py member_coverage counts the hits). The
// port ran the same chain as ATen operations: R advanced-index gathers and
// R - 1 ANDs of (B, n_k, N) bool tensors, then an int64 cast, multiply and
// sum. It writes and reads back ten (256, 200, 1024) bool tensors and two
// int64 copies of that shape for a batch whose input is 65.5 MB.
//
// For each read b of a (B, n_k, R * n_buckets) int32 {0, 1} tensor of the
// bucket filters' answers (the bit-mode probe's output), and each file f of
// the (R, N) file -> bucket assignment, it counts the kmers k that are valid
// and whose answer is 1 in all R repetitions, ans[b, k, r * n_buckets +
// assign[r, f]] == 1 for every r, and writes out[b, f] = count >= need[b]
// (or >= a scalar need) as one byte. Integer arithmetic only: the result is
// the chain's, bit for bit.
//
// What bounds it on an H100: bytes. The answers are read once (65.5 MB at
// the serve batch, (256, 200, 320)), the verdicts written once (256 KB):
// 0.020 ms at 3.35 TB/s. Everything else stays on the SM.
//
// What the design does about it: one block per read (and per tile of up to
// 1024 files), one thread per file. The read's answers are staged in
// shared memory as bit vectors over kmers, one 32-bit word per (repetition,
// bucket, 32 kmers): a warp loads 32 consecutive int32 answers of one kmer
// (a coalesced 128-byte load, the buckets of one repetition in its lanes),
// turns them into a bucket mask with __ballot_sync, and each lane keeps its
// own bucket's bit: after 32 kmers lane i holds bucket i's word. Sixteen
// kmers' loads are in flight before their ballots. Then each thread ANDs
// its file's R words (one bucket of each repetition) for each 32 kmers with
// the valid kmers' word and adds the popcount: R shared loads per 32 kmers,
// where threads of one bucket share a broadcast. Kmers go in chunks of 256
// and repetitions in stripes that fit 48 KB of shared memory, so any read
// length, R and up to 1344 buckets run; the count stays in a register.
// Global traffic is one read of the answers (from L2 again for each extra
// tile of files past the first 1024) and one write of the verdicts.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunkWords = 8;                 // 32-kmer words per chunk
constexpr int kChunk = 32 * kChunkWords;       // kmers per chunk
constexpr int kMaxThreads = 1024;              // files per block
constexpr int kInFlight = 16;                  // answer loads before ballots
constexpr int kSmemBytes = 48 * 1024;          // no opt-in needed
constexpr unsigned kFullMask = 0xffffffffu;

// Shared words: the valid kmers' mask of the chunk, then the stripe's
// (reps, bucket words * 32, kStride) bit vectors. A bucket's kChunkWords
// words take an odd stride, so the threads of a warp, whose files lie in
// distinct buckets, read distinct banks.
constexpr int kStride = kChunkWords + 1;

__host__ __device__ constexpr int rep_words(int bucket_words) {
  return bucket_words * 32 * kStride;
}

__global__ void __launch_bounds__(kMaxThreads)
merge_coverage_kernel(const int32_t* __restrict__ ans,
                      const int32_t* __restrict__ assign,
                      const int32_t* __restrict__ need, int need_all,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ out, int n_k, int n_rep,
                      int n_buckets, int n_files, int rep_step) {
  extern __shared__ unsigned smem[];
  unsigned* kmask = smem;                      // (kChunkWords,)
  unsigned* vecs = smem + kChunkWords;         // (rep_step, pad, kStride)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int bucket_words = (n_buckets + 31) >> 5;
  const int pad = 32 * bucket_words;           // buckets, padded to words
  const int row = n_rep * n_buckets;           // answers per kmer
  const long long b = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = f < n_files;
  const int32_t* read_ans = ans + b * n_k * row;

  int count = 0;
  for (int k0 = 0; k0 < n_k; k0 += kChunk) {
    // the chunk's valid kmers, one word each 32 (0 past n_k)
    for (int w = warp; w < kChunkWords; w += n_warps) {
      const int k = k0 + 32 * w + lane;
      const bool ok = k < n_k && (valid == nullptr || valid[b * n_k + k]);
      const unsigned m = __ballot_sync(kFullMask, ok);
      if (lane == 0) kmask[w] = m;
    }
    unsigned acc[kChunkWords];
    for (int r0 = 0; r0 < n_rep; r0 += rep_step) {
      const int reps = min(rep_step, n_rep - r0);
      // stage: job (rep, bucket word, kmer word) is one warp's 32 loads
      const int jobs = reps * bucket_words * kChunkWords;
      for (int job = warp; job < jobs; job += n_warps) {
        const int kw = job % kChunkWords;
        const int bw = (job / kChunkWords) % bucket_words;
        const int rl = job / (kChunkWords * bucket_words);
        const int bucket = 32 * bw + lane;
        const int kbase = k0 + 32 * kw;
        const int kn = min(32, n_k - kbase);   // warp-uniform
        unsigned bits = 0;
        if (kn > 0) {
          const int32_t* p = read_ans + static_cast<long long>(kbase) * row +
                             (r0 + rl) * n_buckets + bucket;
          const bool lane_ok = bucket < n_buckets;
          for (int j0 = 0; j0 < 32; j0 += kInFlight) {
            int v[kInFlight];
#pragma unroll
            for (int i = 0; i < kInFlight; ++i)
              v[i] = lane_ok && j0 + i < kn
                         ? __ldg(p + static_cast<long long>(j0 + i) * row)
                         : 0;
#pragma unroll
            for (int i = 0; i < kInFlight; ++i) {
              const unsigned m = __ballot_sync(kFullMask, v[i] == 1);
              bits |= ((m >> lane) & 1u) << (j0 + i);
            }
          }
        }
        vecs[(rl * pad + bucket) * kStride + kw] = bits;
      }
      __syncthreads();
      // AND the file's bucket of each repetition of the stripe
      if (active) {
        if (r0 == 0) {
#pragma unroll
          for (int kw = 0; kw < kChunkWords; ++kw) acc[kw] = kmask[kw];
        }
        for (int rl = 0; rl < reps; ++rl) {
          const int a = __ldg(assign + static_cast<long long>(r0 + rl) *
                                           n_files + f);
          // a bucket outside [0, n_buckets) hits nothing (the index checks
          // its assignment when it moves it to the device)
          const bool in = static_cast<unsigned>(a) <
                          static_cast<unsigned>(n_buckets);
          const unsigned* vec = vecs + (rl * pad + (in ? a : 0)) * kStride;
#pragma unroll
          for (int kw = 0; kw < kChunkWords; ++kw)
            acc[kw] &= in ? vec[kw] : 0u;
        }
      }
      __syncthreads();                         // before the next stage
    }
    if (active) {
#pragma unroll
      for (int kw = 0; kw < kChunkWords; ++kw) count += __popc(acc[kw]);
    }
  }
  if (active)
    out[b * n_files + f] = count >= (need != nullptr ? need[b] : need_all);
}

}  // namespace

// out[b, f] = (number of kmers k with valid[b, k] and ans[b, k, r *
// n_buckets + assign[r, f]] == 1 for all r) >= need[b], for n_reads reads of
// n_k kmers and n_files files; need == nullptr compares with need_all, valid
// == nullptr counts every kmer. Launches on `stream`, allocates nothing;
// returns cudaErrorInvalidValue for more than 1344 buckets, else
// cudaGetLastError() (0 on success).
extern "C" int rambo_merge_coverage(const void* ans, const void* assign,
                                    const void* need, int need_all,
                                    const void* valid, void* out, int n_reads,
                                    int n_k, int n_rep, int n_buckets,
                                    int n_files, void* stream) {
  const int per_rep = 4 * rep_words((n_buckets + 31) / 32);
  const int room = kSmemBytes - 4 * kChunkWords;
  if (n_buckets < 1 || n_rep < 1 || per_rep > room)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_reads > 0 && n_files > 0) {
    const int rep_step = std::min(n_rep, room / per_rep);
    const int threads = std::min(kMaxThreads, (n_files + 31) / 32 * 32);
    const dim3 grid(n_reads, (n_files + threads - 1) / threads);
    const int smem = 4 * kChunkWords + rep_step * per_rep;
    merge_coverage_kernel<<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ans), static_cast<const int32_t*>(assign),
        static_cast<const int32_t*>(need), need_all,
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(out), n_k,
        n_rep, n_buckets, n_files, rep_step);
  }
  return static_cast<int>(cudaGetLastError());
}
