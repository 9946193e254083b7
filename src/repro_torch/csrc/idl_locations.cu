// idl_locations: a batch of reads' 2-bit codes to their IDL or RH bit
// locations in one launch, on the 32-bit lane path (idl_locations32) and on
// the 64-bit hash path (idl_locations64).
//
// Replaces, on the rolling location paths, the TPU kernel
// repro/kernels/window_min/kernel.py::window_min together with the location
// body the reference jits around it: repro/core/idl.py's
// idl_locations_rolling32 / rh_locations_rolling32 (32-bit lanes) and
// idl_locations_rolling / rh_locations_rolling with repro/core/minhash.py's
// doph_minhash / minhash_exact / densify_rotation (64-bit hashes). For every
// row of a contiguous (rows, n) uint8 code tensor it writes the
// (eta, n - k + 1) int64 locations in [0, 2^32):
//
//   IDL  psi_j(x) = (j * m' + rho1_j(MinHash_j(x)) + rho2_j(x)) mod 2^32
//   RH   psi_j(x) = (j * m' + h_j(x) mod-range m')          mod 2^32
//
// MinHash_j is the rolling minimum over the kmer's w = k - t + 1 sub-kmers
// (t-mers): in DOPH mode one hash per sub-kmer split into eta bins (the
// masked window minima, then rotation densification of empty bins), in
// exact mode eta independent hashes per sub-kmer.
//
// What bounds it on an H100: at the serving shapes (256 or 512 reads of
// 230 bases, k 31, t 16, eta 4) neither bytes nor operations but the
// launch: the reads are 59 KB, the locations 1.6 MB, the integer work some
// 500 operations a kmer, a few microseconds at the card's rates. Before this
// kernel the same function was ~500 eager launches a batch (packing, the
// murmur mixes, window_min, densification, the range reductions), which
// held the host for 5-7 ms a batch.
//
// What the design does about it: one launch for the whole function, each
// input read once and each output written once. One block per (row, tile of
// kTile kmers) stages the tile's kTile + k - 1 codes (the (k - 1) halo) in
// shared memory with coalesced loads, packs and hashes each of the tile's
// kTile + w - 1 sub-kmers once into shared memory (eta hashes each in exact
// mode), then each thread takes its kmer's eta window minima from there,
// densifies them in registers, hashes its kmer and writes the eta locations,
// coalesced along the kmer axis. eta = 4, the configurations' value, is a
// template instance with every loop over eta unrolled.
//
// The two widths differ where the reference does:
// - 32-bit: sub-kmer hash mix32(x * 0x9E3779B9 + salt) (exact: mix32(x *
//   (2s + 1) + s)); DOPH bin ((h >> 16) * eta) >> 16; empty bin 0xFFFFFFFF;
//   densification CHAINS (each rotation reads the bins the last one
//   filled), offset 0x9E3779B9 * off mod 2^32; the anchor hashes
//   mix32(mh_j * (2j + 3)) and the kmer hash_pair32 of its (hi, lo) lanes,
//   both reduced by hash32_to_range's branch (Lemire split, top-bit shift
//   or modulo), which the host picks per range.
// - 64-bit: sub-kmer and kmer hash64 (murmur3's finalizer on x * c +
//   (c >> 17), c the seed's odd constant, precomputed on the host); DOPH
//   bin ((h >> 32) * eta) >> 32; empty bin UINT64_MAX; densification reads
//   the ORIGINAL minima, offset 0x9E3779B97F4A7C15 * off mod 2^64; every
//   range reduction is ((hash64 >> 32) * m) >> 32, m <= 2^32.
// Native uint32_t / uint64_t arithmetic wraps where the port's int64
// carrier masks, and compares unsigned where it flips the sign bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;      // kmers per block, one per thread
constexpr int kMaxEta = 16;     // the wrapper refuses a larger eta
constexpr int kMaxK = 31;
constexpr size_t kMaxSmem = 48 * 1024;

// hash32_to_range's three branches, chosen on the host: kLemire for
// m < 2^15 (the split Lemire product), kShift for a power of two (the top
// bits), 2 otherwise (h % m)
constexpr int32_t kLemire = 0;
constexpr int32_t kShift = 1;

struct Range {
  uint64_t m;      // the range [0, m)
  int32_t kind;    // 32-bit path: kLemire, kShift or 2 (modulo)
  int32_t shift;   // kShift: 32 - log2(m)
};

// Mirrored field for field by kernels/idl_locations/kernel.py::Config.
struct Config {
  int32_t k, t, eta;
  int32_t rh;      // 1: random-hash locations (no MinHash)
  int32_t exact;   // 1: eta exact MinHashes; 0: densified one-permutation
  int32_t pad;
  uint64_t scale;  // the anchor's multiplier: L when aligned, else 1
  uint64_t m_part;
  Range anchor;    // rho1's range: m' / L (aligned) or m' - L
  Range local;     // rho2's range: L (IDL), or m' (RH)
  uint64_t mh_seed;                // DOPH: the salt (32-bit), its constant (64-bit)
  uint64_t exact_seed[kMaxEta];    // exact: s_j (32-bit), its constant (64-bit)
  uint64_t anchor_seed[kMaxEta];   // 2j + 3 (32-bit), the constant of salt + 31j (64-bit)
  uint64_t local_seed[kMaxEta];    // hash_pair32's seed (32-bit), its constant (64-bit)
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  return x ^ (x >> 33);
}

// hashing.hash64 with c = seed_const64(seed)
__device__ __forceinline__ uint64_t hash64(uint64_t x, uint64_t c) {
  return mix64(x * c + (c >> 17));
}

// hashing.hash_to_range: Lemire on the top 32 bits (hi * m < 2^64)
__device__ __forceinline__ uint64_t range64(uint64_t x, uint64_t c,
                                            uint64_t m) {
  return ((hash64(x, c) >> 32) * m) >> 32;
}

// hashing.hash32_to_range, branch for branch
__device__ __forceinline__ uint32_t range32(uint32_t h, const Range& r) {
  const uint32_t m = static_cast<uint32_t>(r.m);
  if (r.kind == kLemire)
    return ((h >> 16) * m + (((h & 0xFFFFu) * m) >> 16)) >> 16;
  if (r.kind == kShift) return h >> r.shift;
  return h % m;
}

// hashing.hash_pair32: a seeded 32-bit hash of a (hi, lo) 64-bit key
__device__ __forceinline__ uint32_t hash_pair32(uint32_t hi, uint32_t lo,
                                                uint32_t s) {
  const uint32_t c1 = (s * 0x9E3779B9u) | 1u;
  const uint32_t c2 = ((s ^ 0xDEADBEEFu) * 0x85EBCA6Bu) | 1u;
  const uint32_t h = mix32(lo * c1 + c2);
  return mix32(h ^ (hi * c2 + c1));
}

template <bool k64>
struct Lane;

template <>
struct Lane<false> {
  using H = uint32_t;
  static constexpr int kBinShift = 16;
  __device__ static H doph(H x, uint64_t salt) {
    return mix32(x * 0x9E3779B9u + static_cast<uint32_t>(salt));
  }
  __device__ static H exact(H x, uint64_t s) {
    const uint32_t s32 = static_cast<uint32_t>(s);
    return mix32(x * (2u * s32 + 1u) + s32);
  }
  __device__ static H densify_offset(int off) {
    return 0x9E3779B9u * static_cast<uint32_t>(off);
  }
};

template <>
struct Lane<true> {
  using H = uint64_t;
  static constexpr int kBinShift = 32;
  __device__ static H doph(H x, uint64_t c) { return hash64(x, c); }
  __device__ static H exact(H x, uint64_t c) { return hash64(x, c); }
  __device__ static H densify_offset(int off) {
    return 0x9E3779B97F4A7C15ull * static_cast<uint64_t>(off);
  }
};

// kEta > 0: eta is the compile-time kEta (every eta loop unrolled); 0: the
// runtime cfg.eta, at most kMaxEta.
template <bool k64, int kEta>
__global__ void __launch_bounds__(kTile)
locations_kernel(const uint8_t* __restrict__ codes, int64_t* __restrict__ out,
                 int64_t n, int64_t tiles_per_row,
                 const __grid_constant__ Config cfg) {
  using L = Lane<k64>;
  using H = typename L::H;
  constexpr int kE = kEta > 0 ? kEta : kMaxEta;
  constexpr H kEmpty = ~H(0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int eta = kEta > 0 ? kEta : cfg.eta;
  const int k = cfg.k, t = cfg.t, w = k - t + 1;
  const int n_sub = kTile + w - 1;    // sub-kmers a whole tile stages
  const int n_hash = cfg.rh ? 0 : (cfg.exact ? eta : 1);
  H* hashes = reinterpret_cast<H*>(smem_raw);            // [n_hash][n_sub]
  uint8_t* bins = reinterpret_cast<uint8_t*>(hashes + n_hash * n_sub);
  uint8_t* tile = bins + n_sub;                          // [kTile + k - 1]

  const int64_t n_k = n - k + 1;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kTile;
  const int64_t left = n - start;
  const int span = static_cast<int>(
      left < kTile + k - 1 ? left : static_cast<int64_t>(kTile + k - 1));
  const uint8_t* src = codes + row * n + start;
  for (int i = threadIdx.x; i < span; i += kTile) tile[i] = src[i];
  __syncthreads();

  if (!cfg.rh) {
    const int subs = span - t + 1;    // this tile's sub-kmers (<= n_sub)
    for (int s = threadIdx.x; s < subs; s += kTile) {
      H x = 0;
      for (int b = 0; b < t; ++b) x = (x << 2) | tile[s + b];
      if (cfg.exact) {
#pragma unroll
        for (int j = 0; j < kE; ++j)
          if (j < eta) hashes[j * n_sub + s] = L::exact(x, cfg.exact_seed[j]);
      } else {
        const H h = L::doph(x, cfg.mh_seed);
        hashes[s] = h;
        bins[s] = static_cast<uint8_t>(
            ((h >> L::kBinShift) * static_cast<H>(eta)) >> L::kBinShift);
      }
    }
    __syncthreads();
  }

  const int i = threadIdx.x;
  const int64_t kmer = start + i;
  if (kmer >= n_k) return;

  H mh[kE];
  if (!cfg.rh) {
    if (cfg.exact) {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        if (j >= eta) continue;
        const H* hj = hashes + j * n_sub + i;
        H acc = hj[0];
        for (int s = 1; s < w; ++s) acc = hj[s] < acc ? hj[s] : acc;
        mh[j] = acc;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j) mh[j] = kEmpty;
      for (int s = 0; s < w; ++s) {
        const H h = hashes[i + s];
        const int b = bins[i + s];
#pragma unroll
        for (int j = 0; j < kE; ++j)
          if (b == j && h < mh[j]) mh[j] = h;
      }
      if constexpr (!k64) {
        // chained: each rotation reads the minima the last one filled
        for (int off = 1; off < eta; ++off) {
          H next[kE];
#pragma unroll
          for (int j = 0; j < kE; ++j) {
            if (j >= eta) continue;
            const int d = j + off < eta ? j + off : j + off - eta;
            const H donor = mh[d];
            next[j] = mh[j] == kEmpty && donor != kEmpty
                          ? donor + L::densify_offset(off) : mh[j];
          }
#pragma unroll
          for (int j = 0; j < kE; ++j)
            if (j < eta) mh[j] = next[j];
        }
      } else {
        // every rotation reads the original minima
        H orig[kE];
#pragma unroll
        for (int j = 0; j < kE; ++j) orig[j] = mh[j];
        for (int off = 1; off < eta; ++off) {
#pragma unroll
          for (int j = 0; j < kE; ++j) {
            if (j >= eta) continue;
            const int d = j + off < eta ? j + off : j + off - eta;
            const H donor = orig[d];
            if (mh[j] == kEmpty && donor != kEmpty)
              mh[j] = donor + L::densify_offset(off);
          }
        }
      }
    }
  }

  const uint8_t* kc = tile + i;
  int64_t* dst = out + row * eta * n_k + kmer;
  if constexpr (!k64) {
    const int n_hi = k > 16 ? k - 16 : 0;
    uint32_t hi = 0, lo = 0;
    for (int b = 0; b < n_hi; ++b) hi = (hi << 2) | kc[b];
    for (int b = n_hi; b < k; ++b) lo = (lo << 2) | kc[b];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (j >= eta) continue;
      uint32_t loc = range32(
          hash_pair32(hi, lo, static_cast<uint32_t>(cfg.local_seed[j])),
          cfg.local);
      if (!cfg.rh)
        loc += range32(mix32(mh[j] * static_cast<uint32_t>(cfg.anchor_seed[j])),
                       cfg.anchor) * static_cast<uint32_t>(cfg.scale);
      loc += static_cast<uint32_t>(j * cfg.m_part);
      dst[j * n_k] = static_cast<int64_t>(loc);
    }
  } else {
    uint64_t x = 0;
    for (int b = 0; b < k; ++b) x = (x << 2) | kc[b];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (j >= eta) continue;
      uint64_t loc = range64(x, cfg.local_seed[j], cfg.local.m);
      if (!cfg.rh)
        loc += range64(mh[j], cfg.anchor_seed[j], cfg.anchor.m) * cfg.scale;
      loc += static_cast<uint64_t>(j) * cfg.m_part;
      dst[j * n_k] = static_cast<int64_t>(loc & 0xFFFFFFFFull);
    }
  }
}

template <bool k64>
int launch(const uint8_t* codes, int64_t* out, long long rows, long long n,
           const Config* cfg, cudaStream_t stream) {
  using H = typename Lane<k64>::H;
  const int k = cfg->k, t = cfg->t, eta = cfg->eta;
  if (rows < 0 || k < 1 || k > kMaxK || t < 1 || t > k ||
      (!k64 && t > 16) || eta < 1 || eta > kMaxEta || n < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_k = n - k + 1;
  const int64_t tiles_per_row = (n_k + kTile - 1) / kTile;
  if (rows * tiles_per_row > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = k - t + 1;
  const int n_sub = kTile + w - 1;
  const int n_hash = cfg->rh ? 0 : (cfg->exact ? eta : 1);
  const size_t smem = sizeof(H) * static_cast<size_t>(n_hash * n_sub) +
                      n_sub + kTile + k - 1;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>(rows * tiles_per_row);
  if (eta == 4)
    locations_kernel<k64, 4><<<blocks, kTile, smem, stream>>>(
        codes, out, n, tiles_per_row, *cfg);
  else
    locations_kernel<k64, 0><<<blocks, kTile, smem, stream>>>(
        codes, out, n, tiles_per_row, *cfg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes: contiguous (rows, n) uint8 on the device; out: contiguous (rows,
// eta, n - k + 1) int64; cfg: a HOST pointer to the Config (copied into the
// launch's parameters). Launches on `stream`; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int idl_locations32(const void* codes, void* out, long long rows,
                               long long n, const void* cfg, void* stream) {
  return launch<false>(static_cast<const uint8_t*>(codes),
                       static_cast<int64_t*>(out), rows, n,
                       static_cast<const Config*>(cfg),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int idl_locations64(const void* codes, void* out, long long rows,
                               long long n, const void* cfg, void* stream) {
  return launch<true>(static_cast<const uint8_t*>(codes),
                      static_cast<int64_t*>(out), rows, n,
                      static_cast<const Config*>(cfg),
                      static_cast<cudaStream_t>(stream));
}
