// gather_planned_rows: the query side's row gather with the AND over eta.
//
// Replaces the TPU kernel repro/kernels/idl_probe/kernel.py::probe_rows
// (body _probe_rows_kernel) together with what the reference does after
// it: the gather_index realignment of repro/kernels/idl_probe/ops.py and
// the AND over the eta hash repetitions of repro/index/query.py::
// _finish_probe. For every key (b, k) of a (B, eta, n_k) int64 row tensor
// it writes out[b, k, :] = AND over e of matrix[rows[b, e, k], :], one
// W-word answer per key. The TPU needed its plan (runs of one row block,
// -1 pad lanes, scalar-prefetched block ids) to DMA a tile per grid step;
// this card needs neither, so no run plan, pad lane or probe index reaches
// it: a warp loads its own row indices.
//
// What bounds it on an H100: bytes, and the latency of random 128-byte rows
// (W = 32) scattered over a matrix far larger than the 50 MB L2. A 256-read
// serve batch reads 1,638,400 B of row indices and 204,800 rows
// (26,214,400 B), and writes 51,200 answers (6,553,600 B). Each row index is
// a load that the row's load waits for.
//
// What the design does about it: one warp per key, grid-strided, two keys
// in flight per warp (their row indices are loaded before either key's
// rows, so the two dependent-load chains overlap). A row is cut in 16-byte
// units (int4) when W % 4 == 0 and the matrix is 16-byte aligned, else in
// 4-byte words (the same kernel, instantiated on int32). When a row's unit
// count divides 32 the warp's lanes split into 32 / units groups of
// `units` lanes: group g loads repetitions g, g + groups, ... of its unit,
// and a butterfly of __shfl_xor_sync ANDs the groups (at W = 32, eta = 4:
// lane l loads unit l & 7 of repetition l >> 3, every lane one 16-byte
// load, two shuffles, and lanes 0-7 write the 128-byte answer). Other
// widths loop the lanes over the units and each lane over the repetitions.
// Rows are read with __ldg (read-only path) and answers written with
// streaming stores (__stcs): neither is read again. No shared-memory tile:
// at the full configuration a row block of 512 rows holds about one probe
// of a batch, so there is nothing to stage. Row offsets are 64-bit: 2^26
// rows x 32 words is 2^31 words.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kUnroll = 2;  // keys a warp holds in flight
constexpr unsigned kFullMask = 0xffffffffu;

template <typename Unit>
struct Units;

template <>
struct Units<int4> {
  static __device__ __forceinline__ int4 ones() {
    return make_int4(-1, -1, -1, -1);
  }
  // bit s of each word, as 0 or 1
  static __device__ __forceinline__ int4 bit(int4 v, unsigned s) {
    return make_int4((static_cast<unsigned>(v.x) >> s) & 1u,
                     (static_cast<unsigned>(v.y) >> s) & 1u,
                     (static_cast<unsigned>(v.z) >> s) & 1u,
                     (static_cast<unsigned>(v.w) >> s) & 1u);
  }
  static __device__ __forceinline__ int4 band(int4 a, int4 b) {
    return make_int4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  }
  static __device__ __forceinline__ int4 shfl_xor(int4 v, int mask) {
    return make_int4(__shfl_xor_sync(kFullMask, v.x, mask),
                     __shfl_xor_sync(kFullMask, v.y, mask),
                     __shfl_xor_sync(kFullMask, v.z, mask),
                     __shfl_xor_sync(kFullMask, v.w, mask));
  }
};

template <>
struct Units<int32_t> {
  static __device__ __forceinline__ int32_t ones() { return -1; }
  static __device__ __forceinline__ int32_t bit(int32_t v, unsigned s) {
    return (static_cast<unsigned>(v) >> s) & 1u;
  }
  static __device__ __forceinline__ int32_t band(int32_t a, int32_t b) {
    return a & b;
  }
  static __device__ __forceinline__ int32_t shfl_xor(int32_t v, int mask) {
    return __shfl_xor_sync(kFullMask, v, mask);
  }
};

// Element (b, e, k) of the (B, eta, n_k) row (or location) tensor for key =
// b * n_k + k.
__device__ __forceinline__ long long row_of(const long long* rows,
                                            long long key, int e, int eta,
                                            int n_k) {
  return __ldg(rows + ((key / n_k) * eta + e) * n_k + key % n_k);
}

// The unit of the probed row that a lane ANDs in: the row's own unit, or in
// bit mode bit (loc & 31) of each of its words.
template <typename Unit, bool kBits>
__device__ __forceinline__ Unit probe_unit(const Unit* __restrict__ matrix,
                                           long long loc, int units,
                                           int unit) {
  if constexpr (kBits)
    return Units<Unit>::bit(__ldg(matrix + (loc >> 5) * units + unit),
                            static_cast<unsigned>(loc & 31));
  return __ldg(matrix + loc * units + unit);
}

template <typename Unit, bool kBits>
__global__ void __launch_bounds__(kThreads)
gather_and_kernel(const Unit* __restrict__ matrix,
                  const long long* __restrict__ rows, Unit* __restrict__ out,
                  long long n_keys, int n_k, int eta, int units) {
  using U = Units<Unit>;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const long long first =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (units <= 32 && 32 % units == 0) {
    // lane -> (group, unit); group g takes repetitions g, g + groups, ...
    const int unit = lane % units;
    const int group = lane / units;
    const int groups = 32 / units;
    for (long long key = first; key < n_keys; key += kUnroll * warps) {
      Unit acc[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) acc[i] = U::ones();
      for (int e = group; e < eta; e += groups) {
        long long row[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const long long k = key + i * warps;
          row[i] = k < n_keys ? row_of(rows, k, e, eta, n_k) : -1;
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i)
          if (row[i] >= 0)
            acc[i] = U::band(acc[i], probe_unit<Unit, kBits>(
                                         matrix, row[i], units, unit));
      }
      for (int mask = units; mask < 32; mask <<= 1) {
#pragma unroll
        for (int i = 0; i < kUnroll; ++i)
          acc[i] = U::band(acc[i], U::shfl_xor(acc[i], mask));
      }
      if (lane < units) {
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const long long k = key + i * warps;
          if (k < n_keys) __stcs(out + k * units + unit, acc[i]);
        }
      }
    }
  } else {
    for (long long key = first; key < n_keys; key += warps) {
      for (int unit = lane; unit < units; unit += 32) {
        Unit acc = U::ones();
        for (int e = 0; e < eta; ++e)
          acc = U::band(acc, probe_unit<Unit, kBits>(
                                 matrix, row_of(rows, key, e, eta, n_k), units,
                                 unit));
        __stcs(out + key * units + unit, acc);
      }
    }
  }
}

// Blocks that fill the card once (every SM at its occupancy), for the
// grid-stride loop; computed once per instantiation.
template <typename Unit, bool kBits>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_and_kernel<Unit, kBits>, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <typename Unit, bool kBits>
void launch(const void* matrix, const void* rows, void* out,
            long long n_keys, int n_k, int eta, int units,
            cudaStream_t stream) {
  const long long wanted =
      (n_keys + kWarpsPerBlock * kUnroll - 1) / (kWarpsPerBlock * kUnroll);
  const long long cap = resident_blocks<Unit, kBits>();
  const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
  gather_and_kernel<Unit, kBits><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Unit*>(matrix), static_cast<const long long*>(rows),
      static_cast<Unit*>(out), n_keys, n_k, eta, units);
}

template <bool kBits>
int launch_any(const void* matrix, const void* rows, void* out,
               long long n_keys, int n_k, int eta, int row_words, int vector,
               void* stream) {
  if (n_keys > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vector)
      launch<int4, kBits>(matrix, rows, out, n_keys, n_k, eta, row_words / 4,
                          s);
    else
      launch<int32_t, kBits>(matrix, rows, out, n_keys, n_k, eta, row_words,
                             s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[b, k, :] = AND over e of matrix[rows[b, e, k], :] for the n_keys =
// B * n_k keys; `vector` (W % 4 == 0 and a 16-byte aligned matrix) selects
// 16-byte units. Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int gather_planned_rows(const void* matrix, const void* rows,
                                   void* out, long long n_keys, int n_k,
                                   int eta, int row_words, int vector,
                                   void* stream) {
  return launch_any<false>(matrix, rows, out, n_keys, n_k, eta, row_words,
                           vector, stream);
}

// The bit mode: out[b, k, w] = AND over e of bit (locs[b, e, k] & 31) of
// matrix[locs[b, e, k] >> 5, w], as 0 or 1, for the n_keys = B * n_k keys;
// arguments as gather_planned_rows's.
extern "C" int gather_planned_bits(const void* matrix, const void* locs,
                                   void* out, long long n_keys, int n_k,
                                   int eta, int row_words, int vector,
                                   void* stream) {
  return launch_any<true>(matrix, locs, out, n_keys, n_k, eta, row_words,
                          vector, stream);
}
