// B1 and B2: Spark row hashes over fixed-width and STRING columns, for
// Hopper (sm_90a).
//
// Replaces, in the JAX package's ops/pallas_kernels.py:
//   B1 srjt_murmur3_rows  <- build_murmur3_fixed_kernel (:37)
//   B2 srjt_xxhash64_rows <- build_xxhash64_fixed_kernel (:210)
// and, for STRING columns, the JAX package's XLA byte hashes
// (ops/hashing.py _mm_bytes, _xx_bytes): the Pallas kernels take
// fixed-width rows only, and a mixed row is hashed by XLA there. Here one
// launch hashes the whole mixed row, as the reference's CUDA does
// (murmur_hash.cu:187, xxhash64.cu:109-175).
// Plain PyTorch versions: ops/kernels.py (murmur3_fixed_rows_plain,
// xxhash64_fixed_rows_plain), built from ops/hashing.py's mixing functions.
//
// What it computes: per row, the hash seeded with `seed` and chained across
// the columns in order; column c mixes its element (a u32 word, or a u64
// word hashed as two little-endian u32 blocks by murmur3 / one 8-byte round
// by xxhash64, or a string's bytes) into the running hash, and a null
// element (validity byte 0) passes the running hash through. The per-type
// normalization (NaN canonicalization, -0.0 folding for xxhash64, sign
// extension of sub-int types) is done by the caller before the launch.
// A string is hashed as Spark does:
//   murmur3  (compute_bytes, murmur_hash.cuh:95-119): 4-byte little-endian
//            blocks, then each tail byte SIGN-EXTENDED and mixed as a full
//            block (not standard murmur3), then fmix with the byte length;
//   xxhash64 (compute_bytes, xxhash64.cu:109-175): 32-byte stripes into
//            four accumulators, up to three 8-byte rounds, one 4-byte
//            round, then single bytes.
//
// Bound: device-memory bytes. Each row reads 4 or 8 bytes per fixed-width
// column (plus one validity byte for a nullable column), and 8 bytes of
// offsets plus its characters per STRING column, and writes 4 (murmur3) or
// 8 (xxhash64) bytes, against a few tens of integer operations per word;
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
// A string's bytes are read with byte loads (they start at any address);
// a warp's 32 strings lie next to each other, so its loads fall in the
// same few cache lines and each line comes from device memory once. The
// schema (at most 64 columns) rides in the kernel's parameter space.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 64;

enum Kind { kU32 = 0, kU64 = 1, kStr = 2 };

struct HashSchema {
  const void* words[kMaxCols];        // u32 or u64 words, or characters
  const int* offsets[kMaxCols];       // int32[n + 1] of a string column
  const unsigned char* valid[kMaxCols];  // bool[n] or null (all valid)
  int kind[kMaxCols];                 // Kind
  int ncols;
};

// The string of row i of column c: its first byte and its length.
__device__ __forceinline__ const unsigned char* str_at(const HashSchema& s,
                                                       int c, long long i,
                                                       int* len) {
  const int b = __ldg(s.offsets[c] + i);
  *len = __ldg(s.offsets[c] + i + 1) - b;
  return static_cast<const unsigned char*>(s.words[c]) + b;
}

// `nbytes` (<= 8) bytes at p, little-endian.
__device__ __forceinline__ uint64_t load_le(const unsigned char* p,
                                            int nbytes) {
  uint64_t v = 0;
  for (int k = 0; k < nbytes; ++k) v |= (uint64_t)__ldg(p + k) << (8 * k);
  return v;
}

__device__ __forceinline__ bool is_valid(const HashSchema& s, int c,
                                         long long i) {
  return s.valid[c] == nullptr || __ldg(s.valid[c] + i) != 0;
}

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

__device__ __forceinline__ uint32_t mm_bytes(uint32_t h,
                                             const unsigned char* p,
                                             int len) {
  const int nblocks = len / 4;
  for (int k = 0; k < nblocks; ++k) {
    h = mm_block(h, (uint32_t)load_le(p + 4 * k, 4));
  }
  for (int k = 4 * nblocks; k < len; ++k) {
    // Spark's tail: the byte sign-extended, mixed as a whole block
    h = mm_block(h, (uint32_t)(int32_t)(int8_t)__ldg(p + k));
  }
  return mm_fmix(h, (uint32_t)len);
}

// kStrings: the schema has a string column. The fixed-width kernel is a
// separate instantiation: the string code's registers would otherwise cut
// its occupancy (the row hashes are bound by device-memory bytes).
template <bool kStrings>
__global__ void murmur3_rows_kernel(HashSchema s, long long n, uint32_t seed,
                                    uint32_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t h = seed;
    for (int c = 0; c < s.ncols; ++c) {
      if (!is_valid(s, c, i)) continue;  // a null passes the hash through
      if (s.kind[c] == kU32) {
        uint32_t k = __ldg(static_cast<const uint32_t*>(s.words[c]) + i);
        h = mm_fmix(mm_block(h, k), 4u);
      } else if (s.kind[c] == kU64) {
        uint64_t k = __ldg(
            static_cast<const unsigned long long*>(s.words[c]) + i);
        h = mm_fmix(mm_block(mm_block(h, (uint32_t)k), (uint32_t)(k >> 32)),
                    8u);
      } else if constexpr (kStrings) {
        int len;
        const unsigned char* p = str_at(s, c, i, &len);
        h = mm_bytes(h, p, len);
      }
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

__device__ __forceinline__ uint64_t xx_stripe_lane(uint64_t v, uint64_t k) {
  return rotl64(v + k * P2, 31) * P1;
}

__device__ __forceinline__ uint64_t xx_bytes(uint64_t seed,
                                             const unsigned char* p,
                                             int len) {
  uint64_t h;
  int off = 0;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; off + 32 <= len; off += 32) {
      v1 = xx_stripe_lane(v1, load_le(p + off, 8));
      v2 = xx_stripe_lane(v2, load_le(p + off + 8, 8));
      v3 = xx_stripe_lane(v3, load_le(p + off + 16, 8));
      v4 = xx_stripe_lane(v4, load_le(p + off + 24, 8));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    const uint64_t vs[4] = {v1, v2, v3, v4};
    for (int k = 0; k < 4; ++k) h = (h ^ xx_stripe_lane(0, vs[k])) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  for (; off + 8 <= len; off += 8) h = xx_round8(h, load_le(p + off, 8));
  if (off + 4 <= len) {
    h = xx_round4(h, load_le(p + off, 4));
    off += 4;
  }
  for (; off < len; ++off) {
    h = rotl64(h ^ ((uint64_t)__ldg(p + off) * P5), 11) * P1;
  }
  return xx_final(h);
}

template <bool kStrings>
__global__ void xxhash64_rows_kernel(HashSchema s, long long n, uint64_t seed,
                                     uint64_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint64_t h = seed;
    for (int c = 0; c < s.ncols; ++c) {
      if (!is_valid(s, c, i)) continue;  // a null passes the hash through
      if (s.kind[c] == kU32) {
        uint64_t k = __ldg(static_cast<const uint32_t*>(s.words[c]) + i);
        h = xx_final(xx_round4(h + P5 + 4, k));
      } else if (s.kind[c] == kU64) {
        uint64_t k = __ldg(
            static_cast<const unsigned long long*>(s.words[c]) + i);
        h = xx_final(xx_round8(h + P5 + 8, k));
      } else if constexpr (kStrings) {
        int len;
        const unsigned char* p = str_at(s, c, i, &len);
        h = xx_bytes(h, p, len);
      }
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

// Fills the schema; false on a bad schema. *strings: it has a string
// column.
bool fill_schema(HashSchema* s, const void* const* words,
                 const void* const* offsets, const int* kinds,
                 const void* const* valid, int ncols, bool* strings) {
  if (ncols < 0 || ncols > kMaxCols) return false;
  s->ncols = ncols;
  *strings = false;
  for (int c = 0; c < ncols; ++c) {
    *strings = *strings || kinds[c] == kStr;
    if (kinds[c] < kU32 || kinds[c] > kStr) return false;
    if (kinds[c] == kStr && offsets[c] == nullptr) return false;
    s->words[c] = words[c];
    s->offsets[c] = static_cast<const int*>(offsets[c]);
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
int srjt_murmur3_rows(const void* const* words, const void* const* offsets,
                      const int* kinds, const void* const* valid, int ncols,
                      long long n, unsigned int seed, void* out,
                      void* stream) {
  HashSchema s;
  bool strings;
  if (!fill_schema(&s, words, offsets, kinds, valid, ncols, &strings))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  auto kernel = strings ? murmur3_rows_kernel<true>
                        : murmur3_rows_kernel<false>;
  kernel<<<grid_for(n, threads), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      s, n, seed, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

int srjt_xxhash64_rows(const void* const* words, const void* const* offsets,
                       const int* kinds, const void* const* valid, int ncols,
                       long long n, unsigned long long seed, void* out,
                       void* stream) {
  HashSchema s;
  bool strings;
  if (!fill_schema(&s, words, offsets, kinds, valid, ncols, &strings))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  auto kernel = strings ? xxhash64_rows_kernel<true>
                        : xxhash64_rows_kernel<false>;
  kernel<<<grid_for(n, threads), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      s, n, seed, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
