// B3: JCUDF fixed-width + validity row words, for Hopper (sm_90a).
//
// Replaces build_rowconv_fixed_kernel (:414) in the JAX package's
// ops/pallas_kernels.py. Plain PyTorch version: ops/kernels.py
// (rowconv_fixed_words_plain).
//
// What it computes: for each row r, the row's nwords little-endian 32-bit
// words of the JCUDF layout (ops/row_conversion.py's module docstring):
// each column's bytes at its aligned start, then the validity bytes (bit
// c % 8 of byte validity_offset + c / 8 set when column c is valid), then
// zero padding to the 8-byte row alignment. The layout arrives as a plan of
// pieces per output word, made on the host from the schema: a piece names
// a column, which part of its element to read (1, 2 or 4 bytes, the low or
// high half of 8 bytes, or its validity bit) and how far to shift it left.
//
// Bound: device-memory bytes. Each row reads every column's element once
// and writes row_size bytes, with a shift and an OR per piece.
//
// Design against that bound: one thread per row in a grid-stride loop. The
// columns are read in place through the per-column pointer table (no
// u32 lane copies, no lo/hi split of 64-bit columns as on the TPU), so a
// warp reads 32 consecutive elements of each column, coalesced. The row is
// assembled in registers and written with 16-byte stores when row_size is a
// multiple of 16 (8-byte stores otherwise: rows are 8-byte aligned), so the
// output is written once, whole sectors at a time after L2 merges a warp's
// neighbouring rows. The plan and pointer table (a few hundred bytes) are
// read by every thread at the same address and stay in L1.
//
// Metadata (one int64 device array):
//   [data pointers (ncols) | validity pointers or 0 (ncols) |
//    word_first (nwords + 1) | pieces (column | part << 16 | shift << 20)]

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Part { U8 = 0, U16 = 1, U32 = 2, LO = 3, HI = 4, VALID = 5 };

__device__ __forceinline__ uint32_t piece_value(const long long* ptrs,
                                                const long long* valids,
                                                long long piece, long long r) {
  const int c = (int)(piece & 0xFFFF);
  const int part = (int)((piece >> 16) & 0xF);
  const int shift = (int)((piece >> 20) & 31);
  uint32_t v;
  switch (part) {
    case U8:
      v = __ldg(reinterpret_cast<const unsigned char*>(ptrs[c]) + r);
      break;
    case U16:
      v = __ldg(reinterpret_cast<const unsigned short*>(ptrs[c]) + r);
      break;
    case U32:
      v = __ldg(reinterpret_cast<const unsigned int*>(ptrs[c]) + r);
      break;
    case LO:
      v = __ldg(reinterpret_cast<const unsigned int*>(ptrs[c]) + 2 * r);
      break;
    case HI:
      v = __ldg(reinterpret_cast<const unsigned int*>(ptrs[c]) + 2 * r + 1);
      break;
    default: {  // VALID
      const unsigned char* vp =
          reinterpret_cast<const unsigned char*>(valids[c]);
      v = (vp == nullptr || __ldg(vp + r) != 0) ? 1u : 0u;
    }
  }
  return v << shift;
}

__device__ __forceinline__ uint32_t assemble(const long long* ptrs,
                                             const long long* valids,
                                             const long long* first,
                                             const long long* pieces, int w,
                                             long long r) {
  uint32_t acc = 0;
  for (long long p = __ldg(first + w); p < __ldg(first + w + 1); ++p)
    acc |= piece_value(ptrs, valids, __ldg(pieces + p), r);
  return acc;
}

__global__ void rowconv_rows_kernel(const long long* __restrict__ meta,
                                    int ncols, int nwords, long long n,
                                    uint32_t* __restrict__ out) {
  const long long* ptrs = meta;
  const long long* valids = meta + ncols;
  const long long* first = meta + 2 * ncols;
  const long long* pieces = first + nwords + 1;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    uint32_t* row = out + r * nwords;
    if ((nwords & 3) == 0) {
      uint4* dst = reinterpret_cast<uint4*>(row);
      for (int w = 0; w < nwords; w += 4) {
        dst[w / 4] = make_uint4(
            assemble(ptrs, valids, first, pieces, w, r),
            assemble(ptrs, valids, first, pieces, w + 1, r),
            assemble(ptrs, valids, first, pieces, w + 2, r),
            assemble(ptrs, valids, first, pieces, w + 3, r));
      }
    } else {
      uint2* dst = reinterpret_cast<uint2*>(row);
      for (int w = 0; w < nwords; w += 2) {
        dst[w / 2] = make_uint2(assemble(ptrs, valids, first, pieces, w, r),
                                assemble(ptrs, valids, first, pieces, w + 1,
                                         r));
      }
    }
  }
}

}  // namespace

extern "C" {

const char* srjt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). nwords must
// be even (JCUDF rows are 8-byte aligned).
int srjt_rowconv_rows(const void* meta, int ncols, int nwords, long long n,
                      void* out, void* stream) {
  if (nwords <= 0 || (nwords & 1) || ncols < 0 || ncols > 0xFFFF)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  long long cap = (long long)sms * 16;
  int blocks = (int)(want < cap ? want : cap);
  rowconv_rows_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(meta), ncols, nwords, n,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
