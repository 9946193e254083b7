// window_min: the sliding-window minimum, the rolling MinHash core.
//
// Replaces the TPU kernel repro/kernels/window_min/kernel.py::window_min
// (body _window_min_kernel). For each row of a contiguous (rows, n) tensor
// it writes the n - w + 1 window minima, in one of two forms:
//
// - plain (n_bins == 0): out[row, i] = min(a[row, i : i + w]). An
//   (..., eta, n) input of eta MinHash repetitions is eta * ... rows, so
//   one launch computes every repetition (the exact MinHash).
// - binned (the densified one-permutation MinHash; int64 only): each
//   sub-kmer's hash h falls in DOPH bin b(h) = ((h >> s) * n_bins) >> s
//   (the Lemire reduction of the bits above s, computed as uint64: s = 16
//   for the 32-bit path's lanes, 32 for the 64-bit hashes), and for every
//   bin j < n_bins out[row, j, i] = min over t < w of (b(a[row, i + t]) ==
//   j ? a[row, i + t] : fill): the eta masked minima of one MinHash,
//   written as (rows, n_bins, n - w + 1) with no stack. The bins are
//   derived here, so they are neither read nor written in memory.
//
// Types: int64 (the port's carrier of uint32 lanes and of uint64 hashes),
// int32 and float32 (NaN propagates, as torch.minimum does). With
// `is_unsigned` int64 compares as uint64, which spares the caller the two
// sign-flip passes around a signed minimum.
//
// What bounds it on an H100: at the rolling MinHash's shapes, neither bytes
// nor operations but the launch. One binned launch at (256, 215) int64,
// w = 16, eta = 4, reads 440 KB of hashes and writes 1.6 MB: under a
// microsecond at the memory rate, less than a launch costs. At long rows
// (a whole genome) it is bound by bytes: each input is read once.
//
// What the design does about it: one launch per MinHash, each input read
// once. One block per (row, tile of kTile outputs) stages the tile's
// kTile + w - 1 hashes (the TPU kernel's (w - 1) halo), and their bins, in
// shared memory with coalesced loads, once for all n_bins bins; then each
// thread takes, bin by bin, the minimum of its w staged values. The w = 16
// case of the configurations is a template instance with the window
// unrolled. No padding is read or written: a block loads only what lies in
// its row.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;        // outputs per block, one per thread
constexpr int kMaxWindow = 1024;  // the TPU kernel's tile: the widest window

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) {
  return b < a ? b : a;
}

template <>
__device__ __forceinline__ float min_of<float>(float a, float b) {
  return (b < a || b != b) ? b : a;  // a NaN wins, as in torch.minimum
}

// The DOPH bin of a hash, or -1 when it names none of the n_bins bins.
template <typename T>
__device__ __forceinline__ int bin_of(T h, int bin_shift, int n_bins) {
  const uint64_t b =
      ((static_cast<uint64_t>(h) >> bin_shift) * static_cast<uint64_t>(n_bins))
      >> bin_shift;
  return b < static_cast<uint64_t>(n_bins) ? static_cast<int>(b) : -1;
}

// kW > 0: the window is the compile-time kW (unrolled); 0: the runtime w.
// kBinned: the DOPH form (64-bit types only).
template <typename T, int kW, bool kBinned>
__global__ void __launch_bounds__(kTile)
window_min_kernel(const T* __restrict__ a, T* __restrict__ out, int64_t n,
                  int w_arg, int n_bins, int bin_shift, T fill,
                  int64_t tiles_per_row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = kW > 0 ? kW : w_arg;
  T* tile = reinterpret_cast<T*>(smem_raw);
  int* bin_tile = reinterpret_cast<int*>(tile + kTile + w - 1);
  const int64_t n_out = n - w + 1;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kTile;
  const int64_t left = n - start;
  const int span = static_cast<int>(
      left < kTile + w - 1 ? left : static_cast<int64_t>(kTile + w - 1));
  const T* src = a + row * n + start;
  for (int i = threadIdx.x; i < span; i += kTile) {
    const T h = src[i];
    tile[i] = h;
    if constexpr (kBinned) bin_tile[i] = bin_of(h, bin_shift, n_bins);
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (start + i >= n_out) return;
  if constexpr (!kBinned) {
    T acc = tile[i];
#pragma unroll
    for (int s = 1; s < w; ++s) acc = min_of(acc, tile[i + s]);
    out[row * n_out + start + i] = acc;
    return;
  }
  T* dst = out + row * n_bins * n_out + start + i;
  for (int j = 0; j < n_bins; ++j) {
    T acc = fill;
#pragma unroll
    for (int s = 0; s < w; ++s)
      if (bin_tile[i + s] == j) acc = min_of(acc, tile[i + s]);
    dst[j * n_out] = acc;
  }
}

template <typename T, bool kBinned>
void launch(const void* a, void* out, long long rows, long long n, int w,
            int n_bins, int bin_shift, long long fill_bits,
            cudaStream_t stream) {
  const int64_t n_out = n - w + 1;
  const int64_t tiles_per_row = (n_out + kTile - 1) / kTile;
  const unsigned blocks = static_cast<unsigned>(rows * tiles_per_row);
  const size_t smem = (sizeof(T) + (kBinned ? sizeof(int) : 0)) *
                      static_cast<size_t>(kTile + w - 1);
  T fill;  // the low sizeof(T) bytes of fill_bits (little-endian)
  std::memcpy(&fill, &fill_bits, sizeof(T));
  const T* pa = static_cast<const T*>(a);
  T* po = static_cast<T*>(out);
  if (w == 16)
    window_min_kernel<T, 16, kBinned><<<blocks, kTile, smem, stream>>>(
        pa, po, n, w, n_bins, bin_shift, fill, tiles_per_row);
  else
    window_min_kernel<T, 0, kBinned><<<blocks, kTile, smem, stream>>>(
        pa, po, n, w, n_bins, bin_shift, fill, tiles_per_row);
}

}  // namespace

// dtype: 0 int64, 1 int32, 2 float32; is_unsigned (int64 only) compares as
// uint64. n_bins: 0 for the plain form, else the DOPH form (int64 only,
// 0 < bin_shift < 64) and out is (rows, n_bins, n - w + 1); fill_bits
// holds the fill value's bits in its low bytes. Launches on `stream`;
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int window_min(const void* a, void* out, long long rows,
                          long long n, int w, int n_bins, int bin_shift,
                          long long fill_bits, int dtype, int is_unsigned,
                          void* stream) {
  if (w < 1 || w > kMaxWindow || n < w || rows < 0 || n_bins < 0 ||
      (n_bins > 0 && (dtype != 0 || bin_shift < 1 || bin_shift > 63)) ||
      (is_unsigned && dtype != 0) ||
      rows * ((n - w + kTile) / kTile) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool binned = n_bins > 0;
    if (dtype == 0 && is_unsigned) {
      if (binned)
        launch<uint64_t, true>(a, out, rows, n, w, n_bins, bin_shift, fill_bits, s);
      else
        launch<uint64_t, false>(a, out, rows, n, w, 0, 0, fill_bits, s);
    } else if (dtype == 0) {
      if (binned)
        launch<int64_t, true>(a, out, rows, n, w, n_bins, bin_shift, fill_bits, s);
      else
        launch<int64_t, false>(a, out, rows, n, w, 0, 0, fill_bits, s);
    } else if (dtype == 1) {
      launch<int32_t, false>(a, out, rows, n, w, 0, 0, fill_bits, s);
    } else if (dtype == 2) {
      launch<float, false>(a, out, rows, n, w, 0, 0, fill_bits, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
