// window_min: the sliding-window minimum, the rolling MinHash core.
//
// Replaces the TPU kernel repro/kernels/window_min/kernel.py::window_min
// (body _window_min_kernel). For each row of a contiguous (rows, n) tensor
// it writes out[row, i] = min(a[row, i : i + w]) for the n - w + 1 windows,
// for int64 (the port's carrier of uint32 lanes and, after the caller's
// sign flip, of uint64 hashes), int32 and float32 (NaN propagates, as
// torch.minimum does).
//
// What bounds it on an H100: at the rolling MinHash's shapes, neither bytes
// nor operations but the launch. One launch at (256, 215) int64, w = 16,
// reads 440 KB and writes 410 KB: 0.25 us at the memory rate, well under
// the few microseconds a launch costs. The w - 1 comparisons per output are
// a few hundred thousand operations. At long rows (a whole genome) it is
// bound by bytes: each input is read once from device memory.
//
// What the design does about it: it keeps one launch per call and reads
// each input once. One block per (row, tile of kTile outputs) stages the
// tile's kTile + w - 1 inputs (the TPU kernel's (w - 1) halo) in shared
// memory with coalesced loads, then each thread takes the minimum of its w
// values there. No padding is read or written: the block loads only what
// lies inside the row. Fusing the eta DOPH bins of one MinHash into one
// launch is left to a later change.

#include <cstdint>

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

template <typename T>
__global__ void __launch_bounds__(kTile)
window_min_kernel(const T* __restrict__ a, T* __restrict__ out, int64_t n,
                  int w, int64_t tiles_per_row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int64_t n_out = n - w + 1;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kTile;
  const T* src = a + row * n + start;
  const int64_t left = n - start;
  const int span = static_cast<int>(
      left < kTile + w - 1 ? left : static_cast<int64_t>(kTile + w - 1));
  for (int i = threadIdx.x; i < span; i += kTile) tile[i] = src[i];
  __syncthreads();
  const int i = threadIdx.x;
  if (start + i < n_out) {
    T acc = tile[i];
    for (int s = 1; s < w; ++s) acc = min_of(acc, tile[i + s]);
    out[row * n_out + start + i] = acc;
  }
}

template <typename T>
void launch(const void* a, void* out, long long rows, long long n, int w,
            cudaStream_t stream) {
  const int64_t n_out = n - w + 1;
  const int64_t tiles_per_row = (n_out + kTile - 1) / kTile;
  const int64_t blocks = rows * tiles_per_row;
  const size_t smem = sizeof(T) * (kTile + w - 1);
  window_min_kernel<T><<<static_cast<unsigned>(blocks), kTile, smem,
                         stream>>>(static_cast<const T*>(a),
                                   static_cast<T*>(out), n, w, tiles_per_row);
}

}  // namespace

// dtype: 0 int64, 1 int32, 2 float32. Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int window_min(const void* a, void* out, long long rows,
                          long long n, int w, int dtype, void* stream) {
  if (w < 1 || w > kMaxWindow || n < w || rows < 0 ||
      rows * ((n - w + kTile) / kTile) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
      case 0: launch<int64_t>(a, out, rows, n, w, s); break;
      case 1: launch<int32_t>(a, out, rows, n, w, s); break;
      case 2: launch<float>(a, out, rows, n, w, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
