// probe_plan_counts: the compact probe plan's three counters in one pass.
//
// Replaces no TPU kernel: the JAX package plans on the host with numpy
// (repro/kernels/idl_probe/ops.py plan_probe_runs). The port counted the
// planner's runs on the device with an ATen chain around torch.cummax
// (repro_torch/kernels/idl_probe/ref.py run_starts), then took the stream's
// min and max. ATen scans a row with one thread block, and the flattened
// stream is one row: one SM walked all 204,800 probes of a serve batch, in
// about 0.7 ms, while the host waited for the three numbers.
//
// For the (S, n) int64 probe stream, S streams of n probes laid out flat,
// it writes out[0] the planner's run count, out[1] the smallest element,
// out[2] the largest. A run segment starts at each stream's first probe and
// wherever the block, floor(row / block_bits), changes; a run is split every
// per_run probes, so probe j opens a run iff (j - s(j)) % per_run == 0, with
// s(j) the last segment start at or before j. A stream's first probe is a
// start, so s(j) never lies in an earlier stream and the flat test is the
// per-stream one. Integer arithmetic only: the counts are the planner's.
//
// What bounds it on an H100: the stream's bytes, read once (1.6 MB at the
// serve batch, 0.5 us at 3.35 TB/s), and the launch.
//
// What the design does about it: the flat stream is cut into equal chunks,
// one a warp, whatever n is, so the launch fills the card at every shape.
// A warp loads its chunk kUnroll tiles of 32 probes at a time (coalesced,
// all in flight), then walks the tiles: each lane compares its block with
// its left neighbour's (__shfl_up_sync, or the carry at lane 0),
// __ballot_sync gives the tile's segment starts, s(j) is the highest start
// at or below the lane (__clz) or the last start of the warp's earlier
// tiles, and __popc of the openers' ballot adds to the count. The probes
// before a chunk's first start belong to a segment that began in an earlier
// chunk; the warp counts them (its prefix) and leaves them to be resolved
// later. A chunk's record (runs from its first start on, prefix length,
// last start, min, max) appends to its left neighbour's in closed form:
// the prefix continues the neighbour's last segment. Each block folds its
// warps' records into one, in shared memory, and writes it to a workspace;
// the last block to finish (a ticket counter, reset to 0 for the next
// launch) takes the running max of the block records' last starts, which
// gives each block's s at its first probe, and sums. One launch, no second
// pass over the stream. Inner loops keep to shifts and 32-bit arithmetic
// where the sizes allow: a power-of-two block is a shift, a lane's position
// in its stream steps by 32 a tile, and j - s(j) lies within a chunk.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                      // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;                     // tiles a warp loads at once
constexpr long long kStep = 32LL * kUnroll;    // a chunk is a multiple of it
constexpr unsigned kFullMask = 0xffffffffu;

// The counters of a stretch of the stream: runs opened from its first
// segment start on, the probes before that start (its prefix), the last
// start (-1: none) and the smallest and largest probe.
struct Rec {
  long long runs, prefix, last, lo, hi;
};

__device__ __forceinline__ Rec empty_rec() {
  return {0, 0, -1, LLONG_MAX, LLONG_MIN};
}

// The probes at offsets d .. d + m - 1 past a segment's start that open a
// run: the multiples of per_run among them (d >= 1).
__device__ __forceinline__ long long openers(long long d, long long m,
                                             long long per_run) {
  return m > 0 ? (d + m - 1) / per_run - (d - 1) / per_run : 0;
}

// Record `b` of the stretch that starts at `b0`, appended to record `a` of
// the stretch that ends there: b's prefix continues a's last segment (or
// lengthens a's prefix, where a has no start).
__device__ __forceinline__ Rec append(Rec a, Rec b, long long b0,
                                      long long per_run) {
  Rec r;
  if (a.last < 0) {
    r.runs = a.runs + b.runs;
    r.prefix = a.prefix + b.prefix;
  } else {
    r.runs = a.runs + b.runs + openers(b0 - a.last, b.prefix, per_run);
    r.prefix = a.prefix;
  }
  r.last = b.last >= 0 ? b.last : a.last;
  r.lo = min(a.lo, b.lo);
  r.hi = max(a.hi, b.hi);
  return r;
}

// floor(v / block_bits), a shift where block_bits is 1 << shift
__device__ __forceinline__ long long block_of(long long v, long long block_bits,
                                              int shift) {
  if (shift >= 0) return v >> shift;
  const long long q = v / block_bits;
  return (v % block_bits != 0 && v < 0) ? q - 1 : q;
}

// Workspace (int64): [0] the ticket, then five arrays of `capacity` block
// records (runs, prefix, last, lo, hi).
__global__ void __launch_bounds__(kThreads)
plan_counts_kernel(const long long* __restrict__ rows, long long total,
                   long long per_stream, long long block_bits, int shift,
                   long long per_run, long long chunk, int capacity,
                   long long* __restrict__ ws, long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long* rec_runs = ws + 1;
  long long* rec_prefix = rec_runs + capacity;
  long long* rec_last = rec_prefix + capacity;
  long long* rec_lo = rec_last + capacity;
  long long* rec_hi = rec_lo + capacity;
  const unsigned run32 = static_cast<unsigned>(per_run);

  Rec rec = empty_rec();
  const long long a = (static_cast<long long>(blockIdx.x) * kWarps + warp) *
                      chunk;
  if (a < total) {
    const long long b = min(total, a + chunk);
    // the block of the probe left of the chunk (unread at a stream's start)
    long long pos = (a + lane) % per_stream;   // the lane's place in its stream
    long long left_block =
        a % per_stream ? block_of(rows[a - 1], block_bits, shift) : 0;
    long long s = -1;                          // last start so far, or none
    for (long long t0 = a; t0 < b; t0 += kStep) {
      long long v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = t0 + 32 * u + lane;
        v[u] = j < b ? __ldg(rows + j) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long base = t0 + 32 * u;
        if (base >= b) break;                  // warp-uniform
        const long long j = base + lane;
        const bool ok = j < b;
        const long long blk = block_of(v[u], block_bits, shift);
        long long left = __shfl_up_sync(kFullMask, blk, 1);
        if (lane == 0) left = left_block;
        const bool start = ok && (pos == 0 || blk != left);
        const unsigned starts = __ballot_sync(kFullMask, start);
        const unsigned upto = starts & (kFullMask >> (31 - lane));
        const long long sj =
            upto ? base + 31 - __clz(static_cast<int>(upto)) : s;
        // j - sj < chunk < 2^31
        const bool open =
            ok && sj >= 0 && static_cast<unsigned>(j - sj) % run32 == 0;
        rec.runs += __popc(__ballot_sync(kFullMask, open));
        rec.prefix += __popc(__ballot_sync(kFullMask, ok && sj < 0));
        if (starts) s = base + 31 - __clz(static_cast<int>(starts));
        left_block = __shfl_sync(kFullMask, blk, 31);
        if (ok) {
          rec.lo = min(rec.lo, v[u]);
          rec.hi = max(rec.hi, v[u]);
        }
        pos += 32;
        if (pos >= per_stream)
          pos = per_stream >= 32 ? pos - per_stream
                                 : static_cast<int>(pos) %
                                       static_cast<int>(per_stream);
      }
    }
    rec.last = s;
    for (int off = 16; off; off >>= 1) {
      rec.lo = min(rec.lo, __shfl_xor_sync(kFullMask, rec.lo, off));
      rec.hi = max(rec.hi, __shfl_xor_sync(kFullMask, rec.hi, off));
    }
  }

  // the block's record: its warps' records folded in order
  __shared__ Rec warp_rec[kWarps];
  if (lane == 0) warp_rec[warp] = rec;
  __syncthreads();
  if (threadIdx.x == 0) {
    Rec r = warp_rec[0];
    const long long a0 = static_cast<long long>(blockIdx.x) * kWarps * chunk;
    for (int w = 1; w < kWarps; ++w)
      r = append(r, warp_rec[w], a0 + w * chunk, per_run);
    rec_runs[blockIdx.x] = r.runs;
    rec_prefix[blockIdx.x] = r.prefix;
    rec_last[blockIdx.x] = r.last;
    rec_lo[blockIdx.x] = r.lo;
    rec_hi[blockIdx.x] = r.hi;
    __threadfence();
  }

  // the last block to finish folds the block records
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    const unsigned long long ticket =
        atomicAdd(reinterpret_cast<unsigned long long*>(ws), 1ull);
    is_last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // each thread takes a slice of the records; an exclusive running max of
  // the slices' last starts gives s at each slice's first probe
  const int n = gridDim.x;
  const long long span = kWarps * chunk;      // a block record's probes
  const int per = (n + kThreads - 1) / kThreads;
  const int k0 = min(n, static_cast<int>(threadIdx.x) * per);
  const int k1 = min(n, k0 + per);
  __shared__ long long scan[kThreads];
  long long s = -1;
  for (int k = k0; k < k1; ++k) s = max(s, __ldcg(rec_last + k));
  scan[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const long long x =
        static_cast<int>(threadIdx.x) >= off ? scan[threadIdx.x - off] : -1;
    __syncthreads();
    scan[threadIdx.x] = max(scan[threadIdx.x], x);
    __syncthreads();
  }
  s = threadIdx.x ? scan[threadIdx.x - 1] : -1;
  long long runs = 0, lo = LLONG_MAX, hi = LLONG_MIN;
  for (int k = k0; k < k1; ++k) {
    // record 0 has no prefix: its first probe starts a stream
    runs += __ldcg(rec_runs + k) +
            openers(k * span - s, __ldcg(rec_prefix + k), per_run);
    s = max(s, __ldcg(rec_last + k));
    lo = min(lo, __ldcg(rec_lo + k));
    hi = max(hi, __ldcg(rec_hi + k));
  }
  __shared__ long long part[3][kWarps];
  for (int off = 16; off; off >>= 1) {
    runs += __shfl_xor_sync(kFullMask, runs, off);
    lo = min(lo, __shfl_xor_sync(kFullMask, lo, off));
    hi = max(hi, __shfl_xor_sync(kFullMask, hi, off));
  }
  if (lane == 0) {
    part[0][warp] = runs;
    part[1][warp] = lo;
    part[2][warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      runs += part[0][w];
      lo = min(lo, part[1][w]);
      hi = max(hi, part[2][w]);
    }
    out[0] = runs;
    out[1] = lo;
    out[2] = hi;
    *reinterpret_cast<unsigned long long*>(ws) = 0;   // for the next launch
  }
}

}  // namespace

// out[0..2] = (run count, min, max) of the `total` int64 probes at `rows`,
// streams of `per_stream` probes planned in blocks of `block_bits` and runs
// of at most `per_run` probes. `workspace` holds 1 + 5 * capacity int64 and
// its first word is 0 (it is 0 again after each launch); launches that share
// a workspace must not overlap. Launches on `stream`, allocates nothing;
// returns cudaErrorInvalidValue for an empty stream, a ragged last stream, a
// size below 1 or a chunk past 32 bits, else cudaGetLastError() (0 on
// success).
extern "C" int probe_plan_counts(const void* rows, long long total,
                                 long long per_stream, long long block_bits,
                                 long long per_run, void* workspace,
                                 int capacity, void* out, void* stream) {
  if (total < 1 || per_stream < 1 || total % per_stream || block_bits < 1 ||
      per_run < 1 || per_run > INT_MAX || capacity < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the least multiple of kStep that cuts the stream into at most
  // `capacity` blocks of kWarps chunks
  const long long warps = static_cast<long long>(capacity) * kWarps;
  const long long chunk = ((total + warps - 1) / warps + kStep - 1) / kStep *
                          kStep;
  if (chunk > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long span = chunk * kWarps;
  const int blocks = static_cast<int>((total + span - 1) / span);
  const int shift = (block_bits & (block_bits - 1)) ? -1
                                                    : __builtin_ctzll(block_bits);
  plan_counts_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(rows), total, per_stream, block_bits,
      shift, per_run, chunk, capacity, static_cast<long long*>(workspace),
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
