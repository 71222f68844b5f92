// B1 and B2: Spark row hashes over fixed-width columns, for Hopper (sm_90a).
//
// Replaces, in the JAX package's ops/pallas_kernels.py:
//   B1 srjt_murmur3_rows  <- build_murmur3_fixed_kernel (:37)
//   B2 srjt_xxhash64_rows <- build_xxhash64_fixed_kernel (:210)
// Plain PyTorch versions: ops/kernels.py (murmur3_fixed_rows_plain,
// xxhash64_fixed_rows_plain), built from ops/hashing.py's mixing functions.
//
// What it computes: per row, the hash seeded with `seed` and chained across
// the columns in order; column c mixes its element (a u32 word, or a u64
// word hashed as two little-endian u32 blocks by murmur3 / one 8-byte round
// by xxhash64) into the running hash, and a null element (validity byte 0)
// passes the running hash through. The per-type normalization (NaN
// canonicalization, -0.0 folding for xxhash64, sign extension of sub-int
// types) is done by the caller before the launch.
//
// Bound: device-memory bytes. Each row reads 4 or 8 bytes per column (plus
// one validity byte for a nullable column) and writes 4 (murmur3) or 8
// (xxhash64) bytes, against a few tens of integer operations per column;
// at 3.35 TB/s the card moves a row's bytes in less time than its SMs take
// to issue the mixing, so the memory rate is the limit.
//
// Design against that bound: one thread per row in a grid-stride loop, so
// a warp reads 32 consecutive elements of a column (one 128- or 256-byte
// coalesced load) and writes 32 consecutive hashes; every input byte is
// read once and the running hash never leaves a register. 64-bit words are
// read natively (no lo/hi split, unlike the TPU's u32-only lanes), and
// xxhash64's 64-bit multiply and rotate are native instructions instead of
// the TPU kernel's u32-pair emulation (_mulhi_u32, _mul64, _rotl64_pair).
// The schema (at most 64 columns) rides in the kernel's parameter space.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 64;

struct HashSchema {
  const void* words[kMaxCols];        // u32 or u64 per column
  const unsigned char* valid[kMaxCols];  // bool[n] or null (all valid)
  int kind[kMaxCols];                 // 0 = u32, 1 = u64
  int ncols;
};

// ---- murmur3 (Spark's MurmurHash3_32) -------------------------------------
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mm_block(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t mm_fmix(uint32_t h, uint32_t len) {
  h ^= len;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void murmur3_rows_kernel(HashSchema s, long long n, uint32_t seed,
                                    uint32_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t h = seed;
    for (int c = 0; c < s.ncols; ++c) {
      uint32_t nh;
      if (s.kind[c] == 0) {
        uint32_t k = __ldg(static_cast<const uint32_t*>(s.words[c]) + i);
        nh = mm_fmix(mm_block(h, k), 4u);
      } else {
        uint64_t k = __ldg(
            static_cast<const unsigned long long*>(s.words[c]) + i);
        nh = mm_fmix(mm_block(mm_block(h, (uint32_t)k), (uint32_t)(k >> 32)),
                     8u);
      }
      const unsigned char* v = s.valid[c];
      h = (v == nullptr || __ldg(v + i) != 0) ? nh : h;
    }
    out[i] = h;
  }
}

// ---- xxhash64 (Spark's XXHash64) ------------------------------------------
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P3 = 0x165667B19E3779F9ull;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xx_final(uint64_t h) {
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

__device__ __forceinline__ uint64_t xx_round8(uint64_t h, uint64_t k) {
  uint64_t k1 = rotl64(k * P2, 31) * P1;
  h ^= k1;
  return rotl64(h, 27) * P1 + P4;
}

__device__ __forceinline__ uint64_t xx_round4(uint64_t h, uint64_t k) {
  h ^= k * P1;
  return rotl64(h, 23) * P2 + P3;
}

__global__ void xxhash64_rows_kernel(HashSchema s, long long n, uint64_t seed,
                                     uint64_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint64_t h = seed;
    for (int c = 0; c < s.ncols; ++c) {
      uint64_t nh;
      if (s.kind[c] == 0) {
        uint64_t k = __ldg(static_cast<const uint32_t*>(s.words[c]) + i);
        nh = xx_final(xx_round4(h + P5 + 4, k));
      } else {
        uint64_t k = __ldg(
            static_cast<const unsigned long long*>(s.words[c]) + i);
        nh = xx_final(xx_round8(h + P5 + 8, k));
      }
      const unsigned char* v = s.valid[c];
      h = (v == nullptr || __ldg(v + i) != 0) ? nh : h;
    }
    out[i] = h;
  }
}

int grid_for(long long n, int threads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  long long want = (n + threads - 1) / threads;
  long long cap = (long long)sms * 16;  // 16 resident 256-thread blocks/SM
  return (int)(want < cap ? want : cap);
}

bool fill_schema(HashSchema* s, const void* const* words, const int* kinds,
                 const void* const* valid, int ncols) {
  if (ncols < 0 || ncols > kMaxCols) return false;
  s->ncols = ncols;
  for (int c = 0; c < ncols; ++c) {
    s->words[c] = words[c];
    s->kind[c] = kinds[c];
    s->valid[c] = static_cast<const unsigned char*>(valid[c]);
  }
  return true;
}

}  // namespace

extern "C" {

const char* srjt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
int srjt_murmur3_rows(const void* const* words, const int* kinds,
                      const void* const* valid, int ncols, long long n,
                      unsigned int seed, void* out, void* stream) {
  HashSchema s;
  if (!fill_schema(&s, words, kinds, valid, ncols))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  murmur3_rows_kernel<<<grid_for(n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      s, n, seed, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

int srjt_xxhash64_rows(const void* const* words, const int* kinds,
                       const void* const* valid, int ncols, long long n,
                       unsigned long long seed, void* out, void* stream) {
  HashSchema s;
  if (!fill_schema(&s, words, kinds, valid, ncols))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  xxhash64_rows_kernel<<<grid_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      s, n, seed, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
