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
// Design: the chain holds one DADD per row and nothing else.
//
// - The flush leaves the chain. Let s be a partial sum that is not a
//   nonzero subnormal (the flushed chain never holds one) and x a staged
//   input (already flushed: zero, inf, NaN or normal). If x = 0 or
//   |x| >= 2^-969, s + x is not a nonzero subnormal either: were the exact
//   sum nonzero and below 2^-1022, then |s| > 2^-969 - 2^-1022 > 2^-970,
//   so s and x are both multiples of 2^-1022, and so is their nonzero sum,
//   which is then at least 2^-1022. The flush is the identity at such a
//   step. So a chunk none of whose inputs is "tiny" (nonzero, |x| <
//   2^-969) folds with plain adds and gives the flushed chain's bits; a
//   chunk with a tiny input folds with the flush after every add (the
//   second code path; its chunks are counted into *flushed when that
//   pointer is not null). 2^-970 would not do: -(2^-970 - 2^-1023) +
//   2^-970 is 2^-1023.
// - Three warps a block, one segment at a time (grid-stride over
//   segments). The staging warp loads the segment's rows coalesced, one
//   chunk ahead in registers, and writes valid ? daz(z) : +0.0 into a ring
//   of kSlots shared-memory slots of kChunk rows, a chunk's tail padded to
//   kGroup rows with -0.0 (x + -0.0 == x for every x, -0.0 and NaN
//   included). It tests each chunk for tiny inputs and takes no branch per
//   row: its pace must match the fold's. The min/max warp reads the rows
//   again on its own: min and max of the non-NaN rows are an
//   order-independent reduction of a total-order integer image of the
//   bits, per lane and then across the warp. NaN payloads stay off the
//   rows' path: only a chunk that holds a NaN takes ballots, which record
//   the last NaN (sum, staging warp) and the first/last NaN of each sign
//   (min, max).
// - The fold warp folds each slot in row order from shared memory: 16-byte
//   broadcast loads (two rows each) issued ahead of the adds (a full slot
//   unrolled whole, a segment's last slot a group of kGroup rows at a
//   time), every lane alike (the fold is warp-uniform). At the segment's
//   end it replaces a NaN sum by the NaN the staging warp recorded.
// - Named barriers hand the slots over: bar.arrive(full) by the staging
//   warp and bar.sync(full) by the fold warp, the reverse for empty.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;            // rows of one ring slot
constexpr int kSlots = 4;              // slots in each block's ring
constexpr int kGroup = 16;             // rows the fold loads ahead
constexpr int kPerLane = kChunk / 32;  // rows of a chunk each lane stages
constexpr int kBlocksPerSm = 8;
constexpr unsigned kTinyHi = 0x03600000u;       // high word of 2^-969
constexpr unsigned kMinNormalHi = 0x00100000u;  // high word of 2^-1022
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kAbs = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kExpMask = 0x7FF0000000000000LL;
constexpr long long kQuiet = 0x0008000000000000LL;
constexpr long long kDefaultNan = (long long)0xFFF8000000000000ULL;
constexpr long long kPosInf = 0x7FF0000000000000LL;
constexpr long long kNegInf = (long long)0xFFF0000000000000ULL;

struct Ring {
  double2 x[kSlots][kChunk / 2];
  long long nan[kSlots];  // the segment's last NaN input so far; 0: none
  int tiny[kSlots];       // the chunk holds a tiny input
};

__device__ __forceinline__ long long bits_of(double x) {
  return __double_as_longlong(x);
}

__device__ __forceinline__ double flush(double x) {
  const int hi = __double2hiint(x);
  return (hi & 0x7FF00000) == 0 ? __hiloint2double(hi & 0x80000000, 0) : x;
}

// nonzero with |x| < 2^-969, for a flushed x (never subnormal)
__device__ __forceinline__ bool is_tiny(double x) {
  const unsigned hi = (unsigned)__double2hiint(x) & 0x7FFFFFFFu;
  return hi - kMinNormalHi < kTinyHi - kMinNormalHi;
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

// barrier ids: 0 is __syncthreads'; 1..kSlots full, then kSlots empty
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ int full_bar(long long t) {
  return 1 + (int)(t % kSlots);
}

__device__ __forceinline__ int empty_bar(long long t) {
  return 1 + kSlots + (int)(t % kSlots);
}

__device__ __forceinline__ int chunk_rows(long long base, long long e) {
  return e - base < kChunk ? (int)(e - base) : kChunk;
}

__device__ __forceinline__ void load_chunk(const double* __restrict__ z,
                                           const bool* __restrict__ valid,
                                           long long base, long long e,
                                           int lane, double (&v)[kPerLane],
                                           bool (&ok)[kPerLane]) {
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const long long i = base + k * 32 + lane;
    v[k] = i < e ? z[i] : 0.0;
    ok[k] = i < e && valid[i];
  }
}

// The staging warp: every segment's chunks into the ring, with no branch
// per row (its pace must match the fold's); a chunk that holds a NaN
// records the segment's last NaN so far for the fold warp's NaN patch.
__device__ void stage_segments(const double* __restrict__ z,
                               const bool* __restrict__ valid,
                               const long long* __restrict__ starts,
                               long long G, Ring& ring, int lane) {
  long long t = 0;  // chunks staged so far
  for (long long g = blockIdx.x; g < G; g += gridDim.x) {
    const long long b = starts[g], e = starts[g + 1];
    long long sum_nan = 0;
    double cur[kPerLane];
    bool cv[kPerLane];
    load_chunk(z, valid, b, e, lane, cur, cv);
    for (long long base = b; base < e; base += kChunk, ++t) {
      double nxt[kPerLane];
      bool nv[kPerLane];
      load_chunk(z, valid, base + kChunk, e, lane, nxt, nv);  // in flight
      if (t >= kSlots) bar_sync(empty_bar(t));
      const int slot = (int)(t % kSlots);
      double* dst = reinterpret_cast<double*>(ring.x[slot]);
      const int rows = chunk_rows(base, e);
      const int padded = (rows + kGroup - 1) / kGroup * kGroup;
      bool tiny = false;
      unsigned nans = 0;  // bit k: row k * 32 + lane is a valid NaN
      long long xb[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int r = k * 32 + lane;
        const double x = cv[k] ? flush(cur[k]) : 0.0;
        xb[k] = bits_of(x);
        nans |= (unsigned)is_nan(xb[k]) << k;  // x is +0.0 where masked
        tiny |= is_tiny(x);
        if (r < padded) dst[r] = r < rows ? x : -0.0;
      }
      if (__any_sync(kFull, nans != 0)) {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const unsigned nan_lanes = __ballot_sync(kFull, (nans >> k) & 1);
          if (nan_lanes) sum_nan = shfl64(xb[k], 31 - __clz(nan_lanes));
        }
      }
      // every lane writes the same values: the warp stays converged
      ring.tiny[slot] = __any_sync(kFull, tiny);
      ring.nan[slot] = sum_nan;
      bar_arrive(full_bar(t));
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        cur[k] = nxt[k];
        cv[k] = nv[k];
      }
    }
  }
  // the fold warp's releases of the last slots
  for (long long u = t > kSlots ? t - kSlots : 0; u < t; ++u)
    bar_sync(empty_bar(u));
}

// The min/max warp: every segment's min and max, on its own (no barrier).
// Rows take no branch; a chunk that holds a NaN takes the ballots.
__device__ void minmax_segments(const double* __restrict__ z,
                                const bool* __restrict__ valid,
                                const long long* __restrict__ starts,
                                long long G, double* __restrict__ mn,
                                double* __restrict__ mx, int lane) {
  for (long long g = blockIdx.x; g < G; g += gridDim.x) {
    const long long b = starts[g], e = starts[g + 1];
    long long kmin = 0x7FFFFFFFFFFFFFFFLL, kmax = -0x7FFFFFFFFFFFFFFFLL - 1;
    bool any = false;                        // this lane saw a valid non-NaN
    long long first_pos = 0, last_pos = 0, first_neg = 0, last_neg = 0;
    bool has_pos = false, has_neg = false;
    double cur[kPerLane];
    bool cv[kPerLane];
    load_chunk(z, valid, b, e, lane, cur, cv);
    for (long long base = b; base < e; base += kChunk) {
      double nxt[kPerLane];
      bool nv[kPerLane];
      load_chunk(z, valid, base + kChunk, e, lane, nxt, nv);  // in flight
      unsigned nans = 0;  // bit k: row k * 32 + lane is a valid NaN
      long long xb[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        xb[k] = bits_of(cv[k] ? flush(cur[k]) : 0.0);
        const bool xnan = cv[k] && is_nan(xb[k]);
        const bool num = cv[k] && !xnan;
        const long long key = order_key(xb[k]);
        kmin = num && key < kmin ? key : kmin;
        kmax = num && key > kmax ? key : kmax;
        any |= num;
        nans |= (unsigned)xnan << k;
      }
      if (__any_sync(kFull, nans != 0)) {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const bool xnan = (nans >> k) & 1;
          const unsigned pos = __ballot_sync(kFull, xnan && xb[k] >= 0);
          const unsigned neg = __ballot_sync(kFull, xnan && xb[k] < 0);
          if (pos) {
            if (!has_pos) first_pos = shfl64(xb[k], __ffs(pos) - 1);
            last_pos = shfl64(xb[k], 31 - __clz(pos));
            has_pos = true;
          }
          if (neg) {
            if (!has_neg) first_neg = shfl64(xb[k], __ffs(neg) - 1);
            last_neg = shfl64(xb[k], 31 - __clz(neg));
            has_neg = true;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        cur[k] = nxt[k];
        cv[k] = nv[k];
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
      const long long lo = has_pos ? first_pos
                           : has_neg ? last_neg
                           : any ? order_key(kmin) : kPosInf;
      const long long hi = has_neg ? first_neg
                           : has_pos ? last_pos
                           : any ? order_key(kmax) : kNegInf;
      mn[g] = __longlong_as_double(lo);
      mx[g] = __longlong_as_double(hi);
    }
    __syncwarp();
  }
}

template <bool kFlush>
__device__ __forceinline__ double add_row(double acc, double x) {
  const double s = __dadd_rn(acc, x);
  return kFlush ? flush(s) : s;
}

// acc folded over the first `groups` groups of kGroup rows of a slot: the
// next group's loads are issued before the current group's adds.
template <bool kFlush>
__device__ __forceinline__ double fold_slot(double acc, const double2* x,
                                            int groups) {
  constexpr int kQ = kGroup / 2;
  double2 cur[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) cur[q] = x[q];
  for (int gi = 1; gi <= groups; ++gi) {
    const double2* at = x + (gi < groups ? gi : groups - 1) * kQ;
    double2 nxt[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) nxt[q] = at[q];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      acc = add_row<kFlush>(acc, cur[q].x);
      acc = add_row<kFlush>(acc, cur[q].y);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) cur[q] = nxt[q];
  }
  return acc;
}

// acc folded over a full slot, unrolled: no loop work or register moves
// between the adds; the scheduler issues the loads ahead of them.
template <bool kFlush>
__device__ __forceinline__ double fold_full_slot(double acc,
                                                 const double2* x) {
#pragma unroll
  for (int q = 0; q < kChunk / 2; ++q) {
    const double2 v = x[q];
    acc = add_row<kFlush>(acc, v.x);
    acc = add_row<kFlush>(acc, v.y);
  }
  return acc;
}

// The fold warp: every segment's sum, in row order, from the ring.
__device__ void fold_segments(const long long* __restrict__ starts,
                              long long G, double* __restrict__ sum,
                              unsigned long long* __restrict__ flushed,
                              Ring& ring, int lane) {
  long long t = 0;  // chunks folded so far
  unsigned long long nflushed = 0;
  for (long long g = blockIdx.x; g < G; g += gridDim.x) {
    const long long b = starts[g], e = starts[g + 1];
    double acc = 0.0;
    long long nan = 0;
    for (long long base = b; base < e; base += kChunk, ++t) {
      bar_sync(full_bar(t));
      const int slot = (int)(t % kSlots);
      const int groups = (chunk_rows(base, e) + kGroup - 1) / kGroup;
      const bool full = groups == kChunk / kGroup;
      nan = ring.nan[slot];
      if (ring.tiny[slot]) {
        acc = full ? fold_full_slot<true>(acc, ring.x[slot])
                   : fold_slot<true>(acc, ring.x[slot], groups);
        ++nflushed;
      } else {
        acc = full ? fold_full_slot<false>(acc, ring.x[slot])
                   : fold_slot<false>(acc, ring.x[slot], groups);
      }
      bar_arrive(empty_bar(t));
    }
    if (lane == 0) {
      long long s = bits_of(acc);
      if (is_nan(s)) s = nan ? (nan | kQuiet) : kDefaultNan;
      sum[g] = __longlong_as_double(s);
    }
    __syncwarp();
  }
  if (flushed && lane == 0 && nflushed) atomicAdd(flushed, nflushed);
}

__global__ void __launch_bounds__(96, kBlocksPerSm)
segment_float_agg_kernel(const double* __restrict__ z,
                         const bool* __restrict__ valid,
                         const long long* __restrict__ starts, long long G,
                         double* __restrict__ sum, double* __restrict__ mn,
                         double* __restrict__ mx,
                         unsigned long long* __restrict__ flushed) {
  __shared__ Ring ring;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32)
    stage_segments(z, valid, starts, G, ring, lane);
  else if (threadIdx.x < 64)
    fold_segments(starts, G, sum, flushed, ring, lane);
  else
    minmax_segments(z, valid, starts, G, mn, mx, lane);
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

// flushed: null, or an int64 on the card to which the kernel adds its count
// of chunks folded on the flushed path. Returns cudaGetLastError() after
// the launch (0 = launched).
int srjt_segment_float_agg(const double* z, const bool* valid,
                           const long long* starts, long long G, double* sum,
                           double* mn, double* mx, long long* flushed,
                           void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)(sms > 0 ? sms : 132) * kBlocksPerSm;
  long long blocks = G < cap ? G : cap;
  if (blocks < 1) blocks = 1;
  segment_float_agg_kernel<<<(unsigned)blocks, 96, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      z, valid, starts, G, sum, mn, mx,
      reinterpret_cast<unsigned long long*>(flushed));
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
