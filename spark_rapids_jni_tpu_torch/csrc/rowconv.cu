// B3: JCUDF fixed-width + validity row words, for Hopper (sm_90a).
//
// Replaces build_rowconv_fixed_kernel (:414) in the JAX package's
// ops/pallas_kernels.py. Plain PyTorch version: ops/kernels.py
// (rowconv_fixed_words_plain); tile plan and metadata: ops/kernels.py
// (rowconv_tile_plan, rowconv_meta).
//
// What it computes: for each row r, the row's nwords little-endian 32-bit
// words of the JCUDF layout (ops/row_conversion.py's module docstring):
// each column's bytes at its aligned start, then the validity bytes (bit
// c % 8 of byte validity_offset + c / 8 set when column c is valid), then
// zero padding to the 8-byte row alignment.
//
// Bound: device-memory bytes. Each row reads every column's element (and
// validity byte) once and writes row_size bytes; the work between is a
// shift and an OR per piece.
//
// Design against that bound: a shared-memory tile transpose, the design of
// the original CUDA (row_conversion.cu:574). A persistent grid walks
// (tile of R rows, window of words) items. For each item the block stages
// the R-element slice of every column the window reads, and of every
// validity array it reads, into shared memory with 16-byte cp.async copies
// (the ragged head and tail of a slice, and a slice smaller than 16 bytes,
// by byte loads); a slice lands at its source address % 16, so every column
// view, at any element offset, takes the 16-byte copies. Two stages: the
// copies of the block's next item are in flight while the current one is
// assembled, so each SM keeps tens of KB of reads in flight. The block then
// assembles 8-byte word pairs from shared memory — an 8-byte element is one
// 8-byte read — a warp at a time for one pair of 128 rows (4 a lane, their
// loads independent), so the warp runs one piece list, without divergence,
// and reads each slice at consecutive addresses. The pairs go to an output sub-tile in shared
// memory (rows padded to an odd number of pairs: no bank conflicts), which
// the block then stores: when the window is the whole row, the sub-tile's
// output is one contiguous span and thread k stores 16-byte chunks k,
// k + blockDim, ... (a warp stores 512 contiguous bytes); a narrower window
// stores each row's segment with 8-byte stores. The window, piece and pair
// tables are loaded into shared memory once per block, so no piece lookup
// touches device memory.
//
// Metadata (one int64 device array; ops/kernels.rowconv_meta):
//   slot pointers (nslots) | slot info: offset | bytes << 32 (nslots) |
//   windows: pair0 | pair1 << 32, slot0 | slot1 << 32 (2 * nwin) |
//   pair constants (npairs) | pair starts (npairs + 1) |
//   pieces: offset | part << 18 | shift << 21 (npieces)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerLane = 4;  // rows a lane assembles per warp task
// Stages of the ring; ops/kernels.STAGES. Two, with two or more blocks on
// an SM, beat deeper rings of fewer blocks on the H100 (PERF.md).
constexpr int kStages = 2;

enum Part { U8 = 0, U16 = 1, U32 = 2, LO = 3, HI = 4, VALID = 5, U64 = 6 };

// Shared memory of the tables, in this order; ops/kernels._table_bytes
// computes the same size.
__host__ __device__ inline long long table_bytes(int npairs, int nwin,
                                                 int npieces) {
  long long b = 16LL * nwin + 8LL * npairs + 4LL * (npairs + 1) +
                4LL * npieces;
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kStages - 1 groups of this thread are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage rows [row0, row0 + rt) of slots [s0, s1) into `stage`: one warp
// per slot. Byte x of a slice lands at stage + offset + (src % 16) +
// (x - src), so its 16-byte-aligned middle takes cp.async copies.
__device__ void stage_in(unsigned char* stage, const long long* slot_ptr,
                         const long long* slot_info, int s0, int s1,
                         long long row0, int rt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = s0 + warp; s < s1; s += kThreads / 32) {
    const long long info = __ldg(slot_info + s);
    const int nbytes = (int)(info >> 32);
    const unsigned char* a =
        reinterpret_cast<const unsigned char*>(__ldg(slot_ptr + s)) +
        row0 * nbytes;
    const long long len = (long long)rt * nbytes;
    const uintptr_t ai = reinterpret_cast<uintptr_t>(a);
    unsigned char* dst = stage + (int)(info & 0xFFFFFFFF) + (int)(ai & 15);
    const long long head = (long long)((16 - (ai & 15)) & 15);
    const long long mid_end = head + ((len - head) & ~15LL);
    if (len < head + 16) {  // no whole aligned chunk: bytes only
      for (long long i = lane; i < len; i += 32) dst[i] = __ldg(a + i);
      continue;
    }
    if (lane < head) dst[lane] = __ldg(a + lane);
    if (mid_end + lane < len) dst[mid_end + lane] = __ldg(a + mid_end + lane);
    for (long long i = head + 16LL * lane; i < mid_end; i += 16 * 32)
      cp_async16(dst + i, a + i);
  }
}

// Stage item `item` (tile item / nwin, window item % nwin).
__device__ __forceinline__ void stage_item(unsigned char* stage,
                                           const long long* slot_ptr,
                                           const long long* slot_info,
                                           const int4* win, long long item,
                                           int nwin, int R, long long n) {
  const long long row0 = item / nwin * R;
  const int4 w = win[item % nwin];
  const int rt = (int)(n - row0 < R ? n - row0 : R);
  stage_in(stage, slot_ptr, slot_info, w.z, w.w, row0, rt);
}

// ORs pair p of rows r[0..J) of the staged tile into acc: the piece list
// is walked once, each piece decoded once for the J rows, whose loads are
// independent.
template <int J>
__device__ __forceinline__ void pair_rows(const unsigned char* stage,
                                          const unsigned long long* consts,
                                          const uint32_t* first,
                                          const uint32_t* pieces, int p,
                                          const int (&r)[J],
                                          unsigned long long (&acc)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = consts[p];
  const uint32_t k1 = first[p + 1];
  for (uint32_t k = first[p]; k < k1; ++k) {
    const uint32_t pc = pieces[k];
    const unsigned char* src = stage + (pc & 0x3FFFF);
    const int sh = (pc >> 21) & 63;
    const auto* u16 = reinterpret_cast<const unsigned short*>(src);
    const auto* u32 = reinterpret_cast<const uint32_t*>(src);
    const auto* u64 = reinterpret_cast<const unsigned long long*>(src);
    switch ((pc >> 18) & 7) {
      case U8:
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] |= (unsigned long long)src[r[j]] << sh;
        break;
      case U16:
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] |= (unsigned long long)u16[r[j]] << sh;
        break;
      case U32:
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] |= (unsigned long long)u32[r[j]] << sh;
        break;
      case LO:
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] |= (unsigned long long)u32[2 * r[j]] << sh;
        break;
      case HI:
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] |= (unsigned long long)u32[2 * r[j] + 1] << sh;
        break;
      case U64:
#pragma unroll
        for (int j = 0; j < J; ++j) acc[j] |= u64[r[j]] << sh;
        break;
      default:  // VALID
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] |= (unsigned long long)(src[r[j]] != 0) << sh;
    }
  }
}

// At most 64 registers: left to itself, ptxas kept 48 and spilled.
__global__ void __launch_bounds__(kThreads, 4)
    rowconv_tiles_kernel(const long long* __restrict__ meta, int nslots,
                         int nwin, int npairs, int npieces, int rows_per_tile,
                         int stage_bytes, int out_rows, long long n,
                         unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long* slot_ptr = meta;
  const long long* slot_info = slot_ptr + nslots;
  const long long* win_g = slot_info + nslots;
  const long long* consts_g = win_g + 2 * nwin;
  const long long* first_g = consts_g + npairs;
  const long long* pieces_g = first_g + npairs + 1;

  int4* win = reinterpret_cast<int4*>(smem);  // pair0, pair1, slot0, slot1
  unsigned long long* consts =
      reinterpret_cast<unsigned long long*>(smem + 16 * nwin);
  uint32_t* first =
      reinterpret_cast<uint32_t*>(smem + 16 * nwin + 8 * npairs);
  uint32_t* pieces = first + npairs + 1;
  unsigned char* stages = smem + table_bytes(npairs, nwin, npieces);
  unsigned long long* obuf =
      reinterpret_cast<unsigned long long*>(stages + kStages * stage_bytes);

  for (int i = threadIdx.x; i < nwin; i += kThreads) {
    const long long a = win_g[2 * i], b = win_g[2 * i + 1];
    win[i] = make_int4((int)(a & 0xFFFFFFFF), (int)(a >> 32),
                       (int)(b & 0xFFFFFFFF), (int)(b >> 32));
  }
  for (int i = threadIdx.x; i < npairs; i += kThreads)
    consts[i] = (unsigned long long)consts_g[i];
  for (int i = threadIdx.x; i <= npairs; i += kThreads)
    first[i] = (uint32_t)first_g[i];
  for (int i = threadIdx.x; i < npieces; i += kThreads)
    pieces[i] = (uint32_t)pieces_g[i];
  __syncthreads();

  const int R = rows_per_tile;
  const long long items = (n + R - 1) / R * nwin;
  long long it = blockIdx.x;
  if (it >= items) return;

  // ring: item j of this block is staged in stage j % kStages; one commit
  // group per item (empty past the end), kStages - 1 items ahead
  for (int k = 0; k < kStages - 1; ++k) {
    const long long item = it + (long long)k * gridDim.x;
    if (item < items)
      stage_item(stages + k * stage_bytes, slot_ptr, slot_info, win, item,
                 nwin, R, n);
    cp_async_commit();
  }
  for (int j = 0; it < items; it += gridDim.x, ++j) {
    unsigned char* stage = stages + (j % kStages) * stage_bytes;
    const long long ahead = it + (long long)(kStages - 1) * gridDim.x;
    if (ahead < items)
      stage_item(stages + ((j + kStages - 1) % kStages) * stage_bytes,
                 slot_ptr, slot_info, win, ahead, nwin, R, n);
    cp_async_commit();
    cp_async_wait_ring();  // item j's group has landed
    __syncthreads();

    const long long row0 = it / nwin * R;
    const int4 w = win[it % nwin];
    const int rt = (int)(n - row0 < R ? n - row0 : R);
    const int npw = w.y - w.x, stride = npw | 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int sr0 = 0; sr0 < rt; sr0 += out_rows) {
      const int srt = rt - sr0 < out_rows ? rt - sr0 : out_rows;
      const int groups = (srt + 32 * kRowsPerLane - 1) / (32 * kRowsPerLane);
      // assemble: warp task t = (pair, 32 * kRowsPerLane rows); a lane
      // takes rows lane, lane + 32, ... (clamped to the sub-tile for loads)
      for (int t = warp; t < npw * groups; t += kThreads / 32) {
        const int p = t / groups;
        const int rb = (t - p * groups) * 32 * kRowsPerLane + lane;
        int r[kRowsPerLane];
        unsigned long long acc[kRowsPerLane];
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j)
          r[j] = sr0 + min(rb + 32 * j, srt - 1);
        pair_rows(stage, consts, first, pieces, w.x + p, r, acc);
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j)
          if (rb + 32 * j < srt) obuf[(rb + 32 * j) * stride + p] = acc[j];
      }
      __syncthreads();
      if (npw == npairs) {  // the whole row: one contiguous span
        unsigned long long* dst = out + (row0 + sr0) * npairs;
        const int total = srt * npairs, step = 2 * kThreads;
        const int dr = step / npairs, dp = step - dr * npairs;
        int g = 2 * threadIdx.x, r = g / npairs, p = g - r * npairs;
        for (; g < total; g += step) {
          const unsigned long long v0 = obuf[r * stride + p];
          if (g + 1 < total) {
            const int r1 = p + 1 == npairs ? r + 1 : r;
            const int p1 = p + 1 == npairs ? 0 : p + 1;
            __stcs(reinterpret_cast<ulonglong2*>(dst + g),
                   make_ulonglong2(v0, obuf[r1 * stride + p1]));
          } else {
            __stcs(dst + g, v0);
          }
          r += dr;
          p += dp;
          if (p >= npairs) {
            p -= npairs;
            ++r;
          }
        }
      } else {  // a window: each row's segment is contiguous
        const int dr = kThreads / npw, dp = kThreads - dr * npw;
        int r = threadIdx.x / npw, p = threadIdx.x - r * npw;
        for (int i = threadIdx.x; i < srt * npw; i += kThreads) {
          __stcs(out + (row0 + sr0 + r) * npairs + w.x + p,
                 obuf[r * stride + p]);
          r += dr;
          p += dp;
          if (p >= npw) {
            p -= npw;
            ++r;
          }
        }
      }
      __syncthreads();  // obuf is refilled by the next sub-tile
    }
    // the stage is refilled kStages - 1 items on, after the syncs above
  }
  cp_async_wait_all();
}

}  // namespace

extern "C" {

const char* srjt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
// out_rows: rows of the output sub-tile (a multiple of 32); out_bytes: its
// shared memory, at least out_rows * (npw | 1) * 8 for every window's npw.
int srjt_rowconv_rows(const void* meta, int nslots, int nwin, int npairs,
                      int npieces, int rows_per_tile, int stage_bytes,
                      int out_rows, int out_bytes, long long n, void* out,
                      void* stream) {
  if (n <= 0 || nslots < 0 || nwin <= 0 || npairs <= 0 || npieces < 0 ||
      rows_per_tile <= 0 || rows_per_tile % 32 || stage_bytes < 0 ||
      stage_bytes % 16 || out_rows <= 0 || out_rows % 32 ||
      out_bytes < 8 * out_rows ||
      (long long)rows_per_tile * npairs >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long smem =
      table_bytes(npairs, nwin, npieces) + (long long)kStages * stage_bytes +
      out_bytes;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(rowconv_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rowconv_tiles_kernel, kThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items =
      (n + rows_per_tile - 1) / rows_per_tile * (long long)nwin;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(items < cap ? items : cap);
  rowconv_tiles_kernel<<<blocks, kThreads, (size_t)smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(meta), nslots, nwin, npairs, npieces,
      rows_per_tile, stage_bytes, out_rows, n,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
