// H1: ordered segment float aggregate (sum, min, max), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package aggregates floats with plain
// XLA (jax.ops.segment_sum / segment_min / segment_max in
// ops/groupby.py::_segment_agg_fixed), and no torch op on the card gives
// the bits XLA:CPU gives. Plain PyTorch version: ops/kernels.py
// (segment_float_agg_plain); the wrapper: ops/kernels.segment_float_agg.
//
// What it computes, per segment g of rows [starts[g], starts[g+1]) of the
// sorted values z (f64) and their contribution mask valid (bool):
//
//   sum  acc = +0.0; for every row in order:
//        acc = ftz(acc + daz(valid ? z : +0.0))
//        — a sequential left-to-right sum, as XLA:CPU's segment_sum runs
//        it, with its denormals-are-zero inputs and flush-to-zero results
//        (a value whose exponent field is 0 becomes the zero of its sign).
//        A masked row adds +0.0 in its place (jnp.where(valid, z, 0)):
//        skipping it would keep a -0.0 that the +0.0 turns into +0.0.
//        NaN bits: the last NaN input, quieted; a NaN made by inf + -inf
//        is x86's default NaN 0xFFF8000000000000.
//   min  over the valid rows, -0.0 below +0.0; +inf when none is valid.
//        With NaNs among them, x86's minimum (llvm.minimum's lowering,
//        folded in row order) returns the first NaN of positive sign, else
//        the last NaN of negative sign.
//   max  the mirror: -inf when none is valid; the first NaN of negative
//        sign, else the last NaN of positive sign.
//
// Bound: the chain of dependent adds of the longest segment (the order of
// the sum is the contract; nothing is reassociated: __dadd_rn, and the
// build has no fast-math), or the bytes of z and valid when segments are
// short.
//
// Design: one warp per segment (grid-stride over segments). The lanes load
// 32 consecutive rows at a time, coalesced, kDepth chunks of 32 ahead of
// the chunk being folded, so the add chain, not the load latency, sets the
// pace. Every lane folds the chunk in row order from __shfl_sync
// broadcasts (the fold is warp-uniform), each add followed by the flush.
// NaN payloads are kept off the chain: __ballot_sync of the chunk's NaN
// lanes records the last NaN (sum) and the first/last NaN of each sign
// (min, max), and the chain's own NaN is replaced at the end. min and max
// of the non-NaN rows are an order-independent reduction of a total-order
// integer image of the bits, per lane and then across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kDepth = 4;   // chunks of 32 rows each warp holds in flight
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kAbs = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kExpMask = 0x7FF0000000000000LL;
constexpr long long kQuiet = 0x0008000000000000LL;
constexpr long long kDefaultNan = (long long)0xFFF8000000000000ULL;
constexpr long long kPosInf = 0x7FF0000000000000LL;
constexpr long long kNegInf = (long long)0xFFF0000000000000ULL;

__device__ __forceinline__ long long bits_of(double x) {
  return __double_as_longlong(x);
}

__device__ __forceinline__ double flush(double x) {
  const int hi = __double2hiint(x);
  return (hi & 0x7FF00000) == 0 ? __hiloint2double(hi & 0x80000000, 0) : x;
}

__device__ __forceinline__ bool is_nan(long long b) {
  return (b & kAbs) > kExpMask;
}

// signed order of the key == the float order of a non-NaN value, -0 < +0;
// the map is its own inverse
__device__ __forceinline__ long long order_key(long long b) {
  return b ^ ((b >> 63) & kAbs);
}

__device__ __forceinline__ long long shfl64(long long v, int lane) {
  return __shfl_sync(kFull, v, lane);
}

__global__ void __launch_bounds__(kWarps * 32)
segment_float_agg_kernel(const double* __restrict__ z,
                         const bool* __restrict__ valid,
                         const long long* __restrict__ starts, long long G,
                         double* __restrict__ sum, double* __restrict__ mn,
                         double* __restrict__ mx) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       g < G; g += nwarps) {
    const long long b = starts[g], e = starts[g + 1];
    double acc = 0.0;
    long long kmin = 0x7FFFFFFFFFFFFFFFLL, kmax = -0x7FFFFFFFFFFFFFFFLL - 1;
    bool any = false;                        // this lane saw a valid non-NaN
    long long sum_nan = 0, first_pos = 0, last_pos = 0, first_neg = 0,
              last_neg = 0;
    bool has_sum_nan = false, has_pos = false, has_neg = false;

    double cur[kDepth];
    bool cv[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const long long i = b + d * 32 + lane;
      cur[d] = i < e ? z[i] : 0.0;
      cv[d] = i < e && valid[i];
    }
    for (long long base = b; base < e; base += kDepth * 32) {
      double nxt[kDepth];
      bool nv[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {   // the next rows, in flight
        const long long i = base + (kDepth + d) * 32 + lane;
        nxt[d] = i < e ? z[i] : 0.0;
        nv[d] = i < e && valid[i];
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const long long row0 = base + d * 32;
        if (row0 >= e) break;
        const double x = cv[d] ? flush(cur[d]) : 0.0;
        const long long xb = bits_of(x);
        const bool xnan = cv[d] && is_nan(xb);
        const unsigned nan_lanes = __ballot_sync(kFull, xnan);
        if (nan_lanes) {
          const unsigned pos = __ballot_sync(kFull, xnan && xb >= 0);
          const unsigned neg = nan_lanes & ~pos;
          sum_nan = shfl64(xb, 31 - __clz(nan_lanes));
          has_sum_nan = true;
          if (pos) {
            if (!has_pos) first_pos = shfl64(xb, __ffs(pos) - 1);
            last_pos = shfl64(xb, 31 - __clz(pos));
            has_pos = true;
          }
          if (neg) {
            if (!has_neg) first_neg = shfl64(xb, __ffs(neg) - 1);
            last_neg = shfl64(xb, 31 - __clz(neg));
            has_neg = true;
          }
        }
        if (cv[d] && !xnan) {
          const long long k = order_key(xb);
          kmin = k < kmin ? k : kmin;
          kmax = k > kmax ? k : kmax;
          any = true;
        }
        const long long left = e - row0;
        if (left >= 32) {
#pragma unroll
          for (int j = 0; j < 32; ++j)
            acc = flush(__dadd_rn(acc, __shfl_sync(kFull, x, j)));
        } else {
          for (int j = 0; j < (int)left; ++j)
            acc = flush(__dadd_rn(acc, __shfl_sync(kFull, x, j)));
        }
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        cur[d] = nxt[d];
        cv[d] = nv[d];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long a = __shfl_xor_sync(kFull, kmin, off);
      const long long c = __shfl_xor_sync(kFull, kmax, off);
      kmin = a < kmin ? a : kmin;
      kmax = c > kmax ? c : kmax;
    }
    any = __any_sync(kFull, any);
    if (lane == 0) {
      long long s = bits_of(acc);
      if (is_nan(s)) s = has_sum_nan ? (sum_nan | kQuiet) : kDefaultNan;
      const long long lo = has_pos ? first_pos
                           : has_neg ? last_neg
                           : any ? order_key(kmin) : kPosInf;
      const long long hi = has_neg ? first_neg
                           : has_pos ? last_pos
                           : any ? order_key(kmax) : kNegInf;
      sum[g] = __longlong_as_double(s);
      mn[g] = __longlong_as_double(lo);
      mx[g] = __longlong_as_double(hi);
    }
  }
}

// One thread, n dependent f64 adds: the add latency that bounds H1's chain.
__global__ void dadd_chain_kernel(const double* __restrict__ x, long long n,
                                  double* __restrict__ out) {
  double acc = x[0];
  const double step = x[1];
  for (long long i = 0; i < n; ++i) acc = __dadd_rn(acc, step);
  out[0] = acc;
}

}  // namespace

extern "C" {

const char* srjt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
int srjt_segment_float_agg(const double* z, const bool* valid,
                           const long long* starts, long long G, double* sum,
                           double* mn, double* mx, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (G + kWarps - 1) / kWarps;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  segment_float_agg_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      z, valid, starts, G, sum, mn, mx);
  return static_cast<int>(cudaGetLastError());
}

// x: {start, step}; out: one double.
int srjt_dadd_chain(const double* x, long long n, double* out,
                    void* stream) {
  dadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(x, n,
                                                                    out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
