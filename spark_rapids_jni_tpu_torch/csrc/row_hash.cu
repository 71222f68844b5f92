// B1 and B2: Spark row hashes over fixed-width and STRING columns, and
// (B1) LIST columns, for Hopper (sm_90a).
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
// Design against that bound, fixed-width rows (B1 and B2) and B1's
// strings: one thread per row in a grid-stride loop, so a warp reads 32
// consecutive elements of a column (one 128- or 256-byte coalesced load)
// and writes 32 consecutive hashes; every input byte is read once and the
// running hash never leaves a register. 64-bit words are read natively (no
// lo/hi split, unlike the TPU's u32-only lanes), and xxhash64's 64-bit
// multiply and rotate are native instructions instead of the TPU kernel's
// u32-pair emulation (_mulhi_u32, _mul64, _rotl64_pair). B1 reads a
// string's bytes with byte loads.
//
// B2 over a schema with a STRING column (xxhash64_staged_rows_kernel):
// byte loads would issue one load instruction per character, from 32
// scattered addresses per warp instruction. Instead one warp takes a tile
// of kXxTile (128) consecutive rows, lane j rows j, j + 32, j + 64 and
// j + 96, in a grid-stride loop over tiles. For each STRING column the
// warp reads the tile's 129 offsets once (a row's end is its neighbour's
// start, passed by a shuffle) and copies the 16-byte-aligned cover of the
// tile's characters, one contiguous span (~2 KB at 16 bytes a string),
// into its shared-memory stage with 16-byte cp.async copies: one warp
// instruction moves 512 bytes and no character comes from device memory
// twice. Each lane then hashes its four rows from the stage, one after
// the other, building every 8- or 4-byte word from two or three aligned
// 32-bit shared-memory words with funnel shifts. A tile of 128 rows (not
// 32) amortizes the two dependent round trips to device memory (offsets,
// then characters) over four rows a lane. Where the tile's cover exceeds
// the stage (kXxStage bytes), each 32 rows take windows: the longest runs
// of consecutive rows that fit the stage, staged one after the other,
// and a row whose own cover exceeds the stage is hashed by its lane
// straight from device memory, again from aligned 32-bit words (correct,
// not fast). Fixed-width columns of the same schema are read and mixed as
// in the fixed-width kernel, so a mixed row stays one launch. What is
// left between this kernel and its byte bound is measured in PERF.md §6:
// the staging alone runs near the card's copy rate, and the hashing of
// rows of different lengths, whose lanes diverge, adds to it.
// ops/kernels.py (xxhash64_tile_plan, xxhash64_staged_emulation) mirrors
// the tile plan and the word reads in Python for the CPU tests. The schema
// (at most 64 columns) rides in the kernel's parameter space; a longer
// schema takes successive launches, each seeded per row by the hashes of
// the one before (the `seeds` argument: a per-row seed in place of
// `seed`).
//
// B1's LIST entries (kinds kListU32, kListU64, kListStr): Spark's murmur3
// of a LIST column, which the JAX package hashes in an XLA fori_loop
// (ops/hashing.py _apply_unit). A row's elements are [starts[i], ends[i])
// of a flat leaf (the offsets of nested LIST levels composed into one
// range by the caller); the thread that owns the row runs over them in
// order, each element's hash the seed of the next, skipping null elements
// (elem_valid) and the whole row when it is null. The leaf is read as a
// u32, u64 or string entry, as a flat column of that kind. A row's
// elements are consecutive, so a warp reads 32 short runs of the leaf; a
// long row holds its thread while the rest of the warp waits (the chain
// is serial: each element's hash seeds the next; the skewed case is
// measured in PERF.md §6, where loading a row's elements in batches of 8
// ahead of their mixes is measured too: it cost the common case more than
// it gave the long rows). B2 refuses LIST entries (fill_schema): xxhash64
// of a nested column is an error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 64;

enum Kind {
  kU32 = 0, kU64 = 1, kStr = 2,
  kListU32 = 3, kListU64 = 4, kListStr = 5  // kList + the leaf's kind
};
constexpr int kList = kListU32;

struct HashSchema {
  const void* words[kMaxCols];        // u32 or u64 words, or characters
  const int* offsets[kMaxCols];       // int32[rows + 1] of a string leaf
  const unsigned char* valid[kMaxCols];  // bool[n] or null (all valid)
  const int* starts[kMaxCols];        // a list's int32[n] row starts
  const int* ends[kMaxCols];          // a list's int32[n] row ends
  const unsigned char* elem_valid[kMaxCols];  // a list leaf's bool or null
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

// Mixes element i of column c, read as `kind` (kU32, kU64 or kStr), into
// h.
template <bool kStrings>
__device__ __forceinline__ uint32_t mm_element(const HashSchema& s, int c,
                                               int kind, long long i,
                                               uint32_t h) {
  if (kind == kU32) {
    uint32_t k = __ldg(static_cast<const uint32_t*>(s.words[c]) + i);
    return mm_fmix(mm_block(h, k), 4u);
  }
  if (kind == kU64) {
    uint64_t k = __ldg(static_cast<const unsigned long long*>(s.words[c]) +
                       i);
    return mm_fmix(mm_block(mm_block(h, (uint32_t)k), (uint32_t)(k >> 32)),
                   8u);
  }
  if constexpr (kStrings) {
    int len;
    const unsigned char* p = str_at(s, c, i, &len);
    return mm_bytes(h, p, len);
  }
  return h;
}

// kStrings: the schema has a string column or string list leaf; kLists: it
// has a LIST entry. The fixed-width kernel is a separate instantiation: the
// string and list code's registers would otherwise cut its occupancy (the
// row hashes are bound by device-memory bytes).
template <bool kStrings, bool kLists>
__global__ void murmur3_rows_kernel(HashSchema s, long long n, uint32_t seed,
                                    const uint32_t* __restrict__ seeds,
                                    uint32_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t h = seeds == nullptr ? seed : __ldg(seeds + i);
    for (int c = 0; c < s.ncols; ++c) {
      if (!is_valid(s, c, i)) continue;  // a null passes the hash through
      const int kind = s.kind[c];
      if (kLists && kind >= kList) {
        const int leaf = kind - kList;
        const int e = __ldg(s.ends[c] + i);
        const unsigned char* ev = s.elem_valid[c];
        for (int k = __ldg(s.starts[c] + i); k < e; ++k) {
          if (ev != nullptr && __ldg(ev + k) == 0) continue;  // a null
          h = mm_element<kStrings>(s, c, leaf, k, h);
        }
      } else {
        h = mm_element<kStrings>(s, c, kind, i, h);
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

// The kernel for a fixed-width schema; a schema with a STRING column takes
// xxhash64_staged_rows_kernel below.
__global__ void xxhash64_rows_kernel(HashSchema s, long long n, uint64_t seed,
                                     const uint64_t* __restrict__ seeds,
                                     uint64_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint64_t h = seeds == nullptr ? seed : __ldg(seeds + i);
    for (int c = 0; c < s.ncols; ++c) {
      if (!is_valid(s, c, i)) continue;  // a null passes the hash through
      if (s.kind[c] == kU32) {
        uint64_t k = __ldg(static_cast<const uint32_t*>(s.words[c]) + i);
        h = xx_final(xx_round4(h + P5 + 4, k));
      } else if (s.kind[c] == kU64) {
        uint64_t k = __ldg(
            static_cast<const unsigned long long*>(s.words[c]) + i);
        h = xx_final(xx_round8(h + P5 + 8, k));
      }
    }
    out[i] = h;
  }
}

// ---- xxhash64 over STRING columns: warp tiles staged in shared memory ---
// Warps of a block, rows a lane hashes per tile, the bytes of characters
// one warp stages (a multiple of 16), and the blocks an SM must be able to
// hold (it caps the registers: 64 a thread at 8 warps): chosen with
// chip_hash_sweep.py on an H100 (PERF.md §6). ops/kernels.py mirrors
// kXxRowsPerLane and kXxStage (XX_TILE_ROWS, XX_STAGE_BYTES).
constexpr int kXxWarps = 8;
constexpr int kXxRowsPerLane = 4;
constexpr int kXxStage = 4096;
constexpr int kXxBlocksPerSm = 4;
constexpr int kXxTile = 32 * kXxRowsPerLane;  // a warp's tile of rows
constexpr int kXxPad = 16;  // the stage's tail: word reads past a row's end
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The bytes of one row, read as aligned 32-bit words: from the stage in
// shared memory (kShared) or from device memory.
template <bool kShared>
struct RowWords {
  const uint32_t* w;  // the aligned word that holds the row's first byte
  int s;              // that byte's bit offset in it: 0, 8, 16 or 24

  __device__ __forceinline__ explicit RowWords(const unsigned char* p)
      : w(reinterpret_cast<const uint32_t*>(reinterpret_cast<uintptr_t>(p) &
                                            ~uintptr_t{3})),
        s(8 * static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3)) {}

  // Word k. `need`: it holds a byte the caller uses; device memory is read
  // only then, the stage (padded by kXxPad) always.
  __device__ __forceinline__ uint32_t word(int k, bool need) const {
    if constexpr (kShared) {
      return w[k];
    } else {
      return need ? __ldg(w + k) : 0u;
    }
  }

  // Bytes [pos, pos + 4) of the row, pos a multiple of 4, of which the
  // first `nbytes` (1-4) are the row's.
  __device__ __forceinline__ uint32_t u32(int pos, int nbytes) const {
    const int k = pos >> 2;
    return __funnelshift_r(word(k, true), word(k + 1, s + 8 * nbytes > 32),
                           s);
  }

  // Bytes [pos, pos + 8) of the row, pos a multiple of 4, all the row's.
  __device__ __forceinline__ uint64_t u64(int pos) const {
    const int k = pos >> 2;
    const uint32_t a = word(k, true), b = word(k + 1, true),
                   c = word(k + 2, s != 0);
    return (uint64_t)__funnelshift_r(a, b, s) |
           (uint64_t)__funnelshift_r(b, c, s) << 32;
  }
};

// Spark's xxhash64 of `len` bytes seeded with `seed` (compute_bytes).
template <bool kShared>
__device__ __forceinline__ uint64_t xx_row(uint64_t seed,
                                           const RowWords<kShared>& r,
                                           int len) {
  uint64_t h;
  int off = 0;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; off + 32 <= len; off += 32) {
      v1 = xx_stripe_lane(v1, r.u64(off));
      v2 = xx_stripe_lane(v2, r.u64(off + 8));
      v3 = xx_stripe_lane(v3, r.u64(off + 16));
      v4 = xx_stripe_lane(v4, r.u64(off + 24));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    const uint64_t vs[4] = {v1, v2, v3, v4};
    for (int k = 0; k < 4; ++k) h = (h ^ xx_stripe_lane(0, vs[k])) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  for (; off + 8 <= len; off += 8) h = xx_round8(h, r.u64(off));
  if (off + 4 <= len) {
    h = xx_round4(h, r.u32(off, 4));
    off += 4;
  }
  if (off < len) {
    uint32_t t = r.u32(off, len - off);
    for (; off < len; ++off, t >>= 8) {
      h = rotl64(h ^ ((uint64_t)(t & 0xFFu) * P5), 11) * P1;
    }
  }
  return xx_final(h);
}

// Mixes a fixed-width column c of row i into h (`in`: the row is in the
// tile; a null passes the hash through).
__device__ __forceinline__ uint64_t xx_fixed(const HashSchema& s, int c,
                                             long long i, bool in,
                                             uint64_t h) {
  if (!in || !is_valid(s, c, i)) return h;
  if (s.kind[c] == kU32) {
    uint64_t k = __ldg(static_cast<const uint32_t*>(s.words[c]) + i);
    return xx_final(xx_round4(h + P5 + 4, k));
  }
  uint64_t k = __ldg(static_cast<const unsigned long long*>(s.words[c]) + i);
  return xx_final(xx_round8(h + P5 + 8, k));
}

// 32 rows whose characters' cover exceeds the stage: the longest runs of
// consecutive rows whose covers fit one stage, one after the other, each
// copied into `stage` and hashed from there; a row whose own cover exceeds
// the stage is hashed by its lane from device memory. Lane j's row is
// [b, e) of `chars` (past the rows: empty); `valid`: a row, not null. Out
// of line: the rare path keeps its registers out of the tile loop.
__device__ __noinline__ uint64_t xx_string_windows(const unsigned char* chars,
                                                   int rows, int lane, int b,
                                                   int e, bool valid,
                                                   uint64_t h,
                                                   unsigned char* stage) {
  const unsigned res = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(chars) & 15);
  const unsigned char* base = chars - res;
  const int len = e - b;
  // the row's 16-byte-aligned cover [lo, hi), from the aligned base
  const unsigned lo = (b + res) & ~15u, hi = (e + res + 15) & ~15u;
  for (int j0 = 0; j0 < rows;) {
    // rows j0.. whose covers fit one stage with row j0's: a run, as the
    // covers' ends never decrease
    const unsigned w0 = __shfl_sync(kAll, lo, j0);
    const unsigned fit =
        __ballot_sync(kAll, lane >= j0 && hi - w0 <= kXxStage);
    if (!(fit >> j0 & 1u)) {  // row j0 alone exceeds the stage
      if (lane == j0 && valid) h = xx_row(h, RowWords<false>(chars + b), len);
      ++j0;
      continue;
    }
    const int j1 = j0 + __popc(fit);
    const bool mine = valid && lane >= j0 && lane < j1;
    if (__ballot_sync(kAll, mine && len > 0)) {
      // every 16-byte chunk of the cover holds a byte of these rows
      const unsigned w1 = __shfl_sync(kAll, hi, j1 - 1);
      for (unsigned q = w0 + 16 * lane; q < w1; q += 16 * 32) {
        cp_async16(stage + (q - w0), base + q);
      }
      cp_async_wait_all();
    }
    __syncwarp();
    if (mine) h = xx_row(h, RowWords<true>(stage + (b + res - w0)), len);
    __syncwarp();  // the stage is refilled next
    j0 = j1;
  }
  return h;
}

// Mixes STRING column c of the warp's tile, rows [r0, r0 + rows), into the
// lanes' running hashes: h[k] of lane j is row r0 + 32 k + j's. All 32
// lanes call it together. When the cover of the tile's characters fits
// the stage (the common case), one copy stages them all; else each 32 rows
// take xx_string_windows.
__device__ __forceinline__ void xx_string_tile(const HashSchema& s, int c,
                                               long long r0, int rows,
                                               int lane,
                                               uint64_t (&h)[kXxRowsPerLane],
                                               unsigned char* stage) {
  constexpr int K = kXxRowsPerLane;
  const int* off = s.offsets[c] + r0;
  const unsigned char* chars = static_cast<const unsigned char*>(s.words[c]);
  const unsigned res = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(chars) & 15);
  int b[K], e[K];
  bool valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = 32 * k + lane;
    b[k] = __ldg(off + min(j, rows));  // past the tile: its end
    valid[k] = j < rows && is_valid(s, c, r0 + j);
  }
  const int end = __ldg(off + rows);
#pragma unroll
  for (int k = 0; k < K; ++k) {  // a row ends where the next one starts
    const int down = __shfl_down_sync(kAll, b[k], 1);
    const int wrap = k + 1 < K ? __shfl_sync(kAll, b[k + 1], 0) : end;
    e[k] = lane == 31 ? wrap : down;
  }
  // the tile's 16-byte-aligned cover [w0, w1), from the aligned base
  const unsigned w0 = (__shfl_sync(kAll, b[0], 0) + res) & ~15u;
  const unsigned w1 = (end + res + 15) & ~15u;
  if (w1 - w0 > kXxStage) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      h[k] = xx_string_windows(chars, min(max(rows - 32 * k, 0), 32), lane,
                               b[k], e[k], valid[k], h[k], stage);
    }
    return;
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < K; ++k) any = any || (valid[k] && e[k] > b[k]);
  if (__ballot_sync(kAll, any)) {
    // every 16-byte chunk of the cover holds a byte of the tile
    const unsigned char* base = chars - res;
    for (unsigned q = w0 + 16 * lane; q < w1; q += 16 * 32) {
      cp_async16(stage + (q - w0), base + q);
    }
    cp_async_wait_all();
  }
  __syncwarp();
  // one row a lane at a time, not unrolled: the rows rotate through
  // element 0 of the arrays, so the hash's code appears once
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    if (valid[0]) {
      h[0] = xx_row(h[0], RowWords<true>(stage + (b[0] + res - w0)),
                    e[0] - b[0]);
    }
#pragma unroll
    for (int m = 0; m + 1 < K; ++m) {
      const uint64_t th = h[m];
      h[m] = h[m + 1];
      h[m + 1] = th;
      const int tb = b[m];
      b[m] = b[m + 1];
      b[m + 1] = tb;
      const int te = e[m];
      e[m] = e[m + 1];
      e[m + 1] = te;
      const bool tv = valid[m];
      valid[m] = valid[m + 1];
      valid[m + 1] = tv;
    }
  }
  __syncwarp();  // the stage is refilled next
}

__global__ void __launch_bounds__(kXxWarps * 32, kXxBlocksPerSm)
    xxhash64_staged_rows_kernel(HashSchema s, long long n, uint64_t seed,
                                const uint64_t* __restrict__ seeds,
                                uint64_t* __restrict__ out) {
  __shared__ __align__(16) unsigned char stages[kXxWarps][kXxStage + kXxPad];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ntiles = (n + kXxTile - 1) / kXxTile;
  for (long long t = blockIdx.x * (long long)kXxWarps + warp; t < ntiles;
       t += (long long)gridDim.x * kXxWarps) {
    const long long r0 = t * kXxTile;
    const int rows = static_cast<int>(min((long long)kXxTile, n - r0));
    uint64_t h[kXxRowsPerLane];
#pragma unroll
    for (int k = 0; k < kXxRowsPerLane; ++k) {
      const int j = 32 * k + lane;
      h[k] = seeds != nullptr && j < rows ? __ldg(seeds + r0 + j) : seed;
    }
    for (int c = 0; c < s.ncols; ++c) {
      if (s.kind[c] == kStr) {
        xx_string_tile(s, c, r0, rows, lane, h, stages[warp]);
        continue;
      }
#pragma unroll
      for (int k = 0; k < kXxRowsPerLane; ++k) {
        const int j = 32 * k + lane;
        h[k] = xx_fixed(s, c, r0 + j, j < rows, h[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kXxRowsPerLane; ++k) {
      const int j = 32 * k + lane;
      if (j < rows) out[r0 + j] = h[k];
    }
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

// Fills the schema; false on a bad schema (a LIST entry where `lists` is
// false: B2 takes none). *strings: it has a string column or string list
// leaf; *has_lists: it has a LIST entry.
bool fill_schema(HashSchema* s, const void* const* words,
                 const void* const* offsets, const int* kinds,
                 const void* const* valid, const void* const* starts,
                 const void* const* ends, const void* const* elem_valid,
                 int ncols, bool lists, bool* strings, bool* has_lists) {
  if (ncols < 0 || ncols > kMaxCols) return false;
  s->ncols = ncols;
  *strings = false;
  *has_lists = false;
  for (int c = 0; c < ncols; ++c) {
    const int kind = kinds[c];
    if (kind < kU32 || kind > (lists ? kListStr : kStr)) return false;
    const bool is_list = kind >= kList;
    const int leaf = is_list ? kind - kList : kind;
    *strings = *strings || leaf == kStr;
    *has_lists = *has_lists || is_list;
    if (leaf == kStr && offsets[c] == nullptr) return false;
    if (is_list && (starts[c] == nullptr || ends[c] == nullptr)) return false;
    s->words[c] = words[c];
    s->offsets[c] = static_cast<const int*>(offsets[c]);
    s->kind[c] = kind;
    s->valid[c] = static_cast<const unsigned char*>(valid[c]);
    s->starts[c] = is_list ? static_cast<const int*>(starts[c]) : nullptr;
    s->ends[c] = is_list ? static_cast<const int*>(ends[c]) : nullptr;
    s->elem_valid[c] =
        is_list ? static_cast<const unsigned char*>(elem_valid[c]) : nullptr;
  }
  return true;
}

}  // namespace

extern "C" {

const char* srjt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). `seeds`:
// uint32[n] per-row seeds in place of `seed`, or null.
int srjt_murmur3_rows(const void* const* words, const void* const* offsets,
                      const int* kinds, const void* const* valid,
                      const void* const* starts, const void* const* ends,
                      const void* const* elem_valid, int ncols, long long n,
                      unsigned int seed, const void* seeds, void* out,
                      void* stream) {
  HashSchema s;
  bool strings, lists;
  if (!fill_schema(&s, words, offsets, kinds, valid, starts, ends,
                   elem_valid, ncols, true, &strings, &lists))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  auto kernel = strings ? (lists ? murmur3_rows_kernel<true, true>
                                 : murmur3_rows_kernel<true, false>)
                        : (lists ? murmur3_rows_kernel<false, true>
                                 : murmur3_rows_kernel<false, false>);
  kernel<<<grid_for(n, threads), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      s, n, seed, static_cast<const uint32_t*>(seeds),
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// `seeds`: uint64[n] per-row seeds in place of `seed`, or null.
int srjt_xxhash64_rows(const void* const* words, const void* const* offsets,
                       const int* kinds, const void* const* valid,
                       const void* const* starts, const void* const* ends,
                       const void* const* elem_valid, int ncols, long long n,
                       unsigned long long seed, const void* seeds, void* out,
                       void* stream) {
  HashSchema s;
  bool strings, lists;
  if (!fill_schema(&s, words, offsets, kinds, valid, starts, ends,
                   elem_valid, ncols, false, &strings, &lists))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (strings) {
    const int threads = kXxWarps * 32;
    xxhash64_staged_rows_kernel<<<grid_for((n + kXxRowsPerLane - 1) /
                                               kXxRowsPerLane,
                                           threads),
                                  threads, 0, st>>>(
        s, n, seed, static_cast<const uint64_t*>(seeds),
        static_cast<uint64_t*>(out));
  } else {
    const int threads = 256;
    xxhash64_rows_kernel<<<grid_for(n, threads), threads, 0, st>>>(
        s, n, seed, static_cast<const uint64_t*>(seeds),
        static_cast<uint64_t*>(out));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
