// H2: Spark's DECIMAL128 arithmetic, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes decimals with
// 256-bit limb math in XLA ops (ops/int256.py under ops/decimal128.py),
// whose division is a loop of 256 masked shift-compare-subtract steps over
// the whole column. The reference does this in decimal_utils.cu, one
// thread a row. Plain PyTorch version: ops/decimal128.py (op_plain, over
// ops/int256.py); the wrapper: ops/kernels.decimal128_op.
//
// What it computes, per row i, for one operation (enum Op) on a[i] and
// b[i] (two's-complement 128-bit values; either operand may have row
// stride 0, a literal) at the host-known cudf scales a_c, b_c -> out_c:
// add, sub, multiply (with the SPARK-40129 interim cast to 38 digits when
// cast_interim is set), divide (HALF_UP), integer_divide (truncating, the
// low 64 bits of the 256-bit quotient) and remainder (Java's definition),
// with the JAX package's semantics bit for bit: the 256-bit intermediates
// wrap mod 2^256, precision10 counts 77 past 10^76, a zero divisor gives
// overflow and a zero result, and the long division of n by d is the
// JAX package's bit-serial one, including its edges (d == 0: quotient all
// ones, remainder n; d >= 2^255: the shifted remainder wraps mod 2^256).
// Outputs: the result (int32[n, 4] limbs, or int64[n]) and overflow
// (bool[n]). A power of ten past 10^76 that only a row's value asks for
// (multiply's rescale after the interim cast) sets *err when err is not
// null: the wrapper raises, as the plain version does.
//
// Bound: bytes, 2 x 16 B read and 17 B written a row, where no division
// runs (add, sub, q1's multiplies); a division's loop (up to 256 steps of
// a 256-bit shift, compare and subtract) makes divide and remainder
// bound by their instructions.
//
// Design: one thread a row, everything in registers: a 256-bit value is
// four 64-bit words, products by __umul64hi, carries by compares. The
// powers of ten 10^0..10^76 are a table in constant memory (2.4 KB);
// precision10 is a binary search of it. The division keeps the JAX
// package's bit-serial loop but starts at the numerator's top set bit (the
// steps above it leave a zero remainder, which a nonzero divisor never
// reaches), and takes the hardware's 64-bit division where both operands
// fit 64 bits (for d < 2^255 the bit-serial loop is exact division, so the
// two agree); the loop is not unrolled, so one trip of it in the SASS is
// one step (chip_smoke.py counts its instructions for divide's bound).
// The operation is a template parameter: one specialised kernel per op.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3, kIntDiv = 4, kRem = 5 };

struct U256 {
  uint64_t w[4];  // little-endian 64-bit words
};

__constant__ uint64_t kPow10[77][4] = {
    {0x0000000000000001ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e0
    {0x000000000000000aull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e1
    {0x0000000000000064ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e2
    {0x00000000000003e8ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e3
    {0x0000000000002710ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e4
    {0x00000000000186a0ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e5
    {0x00000000000f4240ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e6
    {0x0000000000989680ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e7
    {0x0000000005f5e100ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e8
    {0x000000003b9aca00ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e9
    {0x00000002540be400ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e10
    {0x000000174876e800ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e11
    {0x000000e8d4a51000ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e12
    {0x000009184e72a000ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e13
    {0x00005af3107a4000ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e14
    {0x00038d7ea4c68000ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e15
    {0x002386f26fc10000ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e16
    {0x016345785d8a0000ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e17
    {0x0de0b6b3a7640000ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e18
    {0x8ac7230489e80000ull, 0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e19
    {0x6bc75e2d63100000ull, 0x0000000000000005ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e20
    {0x35c9adc5dea00000ull, 0x0000000000000036ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e21
    {0x19e0c9bab2400000ull, 0x000000000000021eull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e22
    {0x02c7e14af6800000ull, 0x000000000000152dull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e23
    {0x1bcecceda1000000ull, 0x000000000000d3c2ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e24
    {0x161401484a000000ull, 0x0000000000084595ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e25
    {0xdcc80cd2e4000000ull, 0x000000000052b7d2ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e26
    {0x9fd0803ce8000000ull, 0x00000000033b2e3cull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e27
    {0x3e25026110000000ull, 0x00000000204fce5eull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e28
    {0x6d7217caa0000000ull, 0x00000001431e0faeull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e29
    {0x4674edea40000000ull, 0x0000000c9f2c9cd0ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e30
    {0xc0914b2680000000ull, 0x0000007e37be2022ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e31
    {0x85acef8100000000ull, 0x000004ee2d6d415bull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e32
    {0x38c15b0a00000000ull, 0x0000314dc6448d93ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e33
    {0x378d8e6400000000ull, 0x0001ed09bead87c0ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e34
    {0x2b878fe800000000ull, 0x0013426172c74d82ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e35
    {0xb34b9f1000000000ull, 0x00c097ce7bc90715ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e36
    {0x00f436a000000000ull, 0x0785ee10d5da46d9ull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e37
    {0x098a224000000000ull, 0x4b3b4ca85a86c47aull, 0x0000000000000000ull, 0x0000000000000000ull},  // 1e38
    {0x5f65568000000000ull, 0xf050fe938943acc4ull, 0x0000000000000002ull, 0x0000000000000000ull},  // 1e39
    {0xb9f5610000000000ull, 0x6329f1c35ca4bfabull, 0x000000000000001dull, 0x0000000000000000ull},  // 1e40
    {0x4395ca0000000000ull, 0xdfa371a19e6f7cb5ull, 0x0000000000000125ull, 0x0000000000000000ull},  // 1e41
    {0xa3d9e40000000000ull, 0xbc627050305adf14ull, 0x0000000000000b7aull, 0x0000000000000000ull},  // 1e42
    {0x6682e80000000000ull, 0x5bd86321e38cb6ceull, 0x00000000000072cbull, 0x0000000000000000ull},  // 1e43
    {0x011d100000000000ull, 0x9673df52e37f2410ull, 0x0000000000047bf1ull, 0x0000000000000000ull},  // 1e44
    {0x0b22a00000000000ull, 0xe086b93ce2f768a0ull, 0x00000000002cd76full, 0x0000000000000000ull},  // 1e45
    {0x6f5a400000000000ull, 0xc5433c60ddaa1640ull, 0x0000000001c06a5eull, 0x0000000000000000ull},  // 1e46
    {0x5986800000000000ull, 0xb4a05bc8a8a4de84ull, 0x00000000118427b3ull, 0x0000000000000000ull},  // 1e47
    {0x7f41000000000000ull, 0x0e4395d69670b12bull, 0x00000000af298d05ull, 0x0000000000000000ull},  // 1e48
    {0xf88a000000000000ull, 0x8ea3da61e066ebb2ull, 0x00000006d79f8232ull, 0x0000000000000000ull},  // 1e49
    {0xb564000000000000ull, 0x926687d2c40534fdull, 0x000000446c3b15f9ull, 0x0000000000000000ull},  // 1e50
    {0x15e8000000000000ull, 0xb8014e3ba83411e9ull, 0x000002ac3a4edbbfull, 0x0000000000000000ull},  // 1e51
    {0xdb10000000000000ull, 0x300d0e549208b31aull, 0x00001aba4714957dull, 0x0000000000000000ull},  // 1e52
    {0x8ea0000000000000ull, 0xe0828f4db456ff0cull, 0x00010b46c6cdd6e3ull, 0x0000000000000000ull},  // 1e53
    {0x9240000000000000ull, 0xc51999090b65f67dull, 0x000a70c3c40a64e6ull, 0x0000000000000000ull},  // 1e54
    {0xb680000000000000ull, 0xb2fffa5a71fba0e7ull, 0x006867a5a867f103ull, 0x0000000000000000ull},  // 1e55
    {0x2100000000000000ull, 0xfdffc78873d4490dull, 0x04140c78940f6a24ull, 0x0000000000000000ull},  // 1e56
    {0x4a00000000000000ull, 0xebfdcb54864ada83ull, 0x28c87cb5c89a2571ull, 0x0000000000000000ull},  // 1e57
    {0xe400000000000000ull, 0x37e9f14d3eec8920ull, 0x97d4df19d6057673ull, 0x0000000000000001ull},  // 1e58
    {0xe800000000000000ull, 0x2f236d04753d5b48ull, 0xee50b7025c36a080ull, 0x000000000000000full},  // 1e59
    {0x1000000000000000ull, 0xd762422c946590d9ull, 0x4f2726179a224501ull, 0x000000000000009full},  // 1e60
    {0xa000000000000000ull, 0x69d695bdcbf7a87aull, 0x17877cec0556b212ull, 0x0000000000000639ull},  // 1e61
    {0x4000000000000000ull, 0x2261d969f7ac94caull, 0xeb4ae1383562f4b8ull, 0x0000000000003e3aull},  // 1e62
    {0x8000000000000000ull, 0x57d27e23acbdcfe6ull, 0x30eccc3215dd8f31ull, 0x0000000000026e4dull},  // 1e63
    {0x0000000000000000ull, 0x6e38ed64bf6a1f01ull, 0xe93ff9f4daa797edull, 0x0000000000184f03ull},  // 1e64
    {0x0000000000000000ull, 0x4e3945ef7a25360aull, 0x1c7fc3908a8bef46ull, 0x0000000000f31627ull},  // 1e65
    {0x0000000000000000ull, 0x0e3cbb5ac5741c64ull, 0x1cfda3a5697758bfull, 0x00000000097edd87ull},  // 1e66
    {0x0000000000000000ull, 0x8e5f518bb6891be8ull, 0x21e864761ea97776ull, 0x000000005ef4a747ull},  // 1e67
    {0x0000000000000000ull, 0x8fb92f75215b1710ull, 0x5313ec9d329eaaa1ull, 0x00000003b58e88c7ull},  // 1e68
    {0x0000000000000000ull, 0x9d3bda934d8ee6a0ull, 0x3ec73e23fa32aa4full, 0x00000025179157c9ull},  // 1e69
    {0x0000000000000000ull, 0x245689c107950240ull, 0x73c86d67c5faa71cull, 0x00000172ebad6ddcull},  // 1e70
    {0x0000000000000000ull, 0x6b61618a4bd21680ull, 0x85d4460dbbca8719ull, 0x00000e7d34c64a9cull},  // 1e71
    {0x0000000000000000ull, 0x31cdcf66f634e100ull, 0x3a4abc8955e946feull, 0x000090e40fbeea1dull},  // 1e72
    {0x0000000000000000ull, 0xf20a1a059e10ca00ull, 0x46eb5d5d5b1cc5edull, 0x0005a8e89d752524ull},  // 1e73
    {0x0000000000000000ull, 0x746504382ca7e400ull, 0xc531a5a58f1fbb4bull, 0x003899162693736aull},  // 1e74
    {0x0000000000000000ull, 0x8bf22a31be8ee800ull, 0xb3f07877973d50f2ull, 0x0235fadd81c2822bull},  // 1e75
    {0x0000000000000000ull, 0x7775a5f171951000ull, 0x0764b4abe8652979ull, 0x161bcca7119915b5ull},  // 1e76
};

__device__ __forceinline__ U256 make(uint64_t lo) {
  U256 r;
  r.w[0] = lo;
  r.w[1] = r.w[2] = r.w[3] = 0;
  return r;
}

__device__ __forceinline__ U256 pow10(int e) {
  U256 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.w[k] = kPow10[e][k];
  return r;
}

__device__ __forceinline__ bool is_neg(const U256& a) {
  return (a.w[3] >> 63) != 0;
}

__device__ __forceinline__ bool is_zero(const U256& a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

__device__ __forceinline__ U256 add(const U256& a, const U256& b) {
  U256 r;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t s = a.w[k] + b.w[k];
    const uint64_t t = s + c;
    c = (s < a.w[k]) | (t < s);
    r.w[k] = t;
  }
  return r;
}

__device__ __forceinline__ U256 sub(const U256& a, const U256& b) {
  U256 r;
  uint64_t br = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t d = a.w[k] - b.w[k];
    const uint64_t t = d - br;
    br = (a.w[k] < b.w[k]) | (d < br);
    r.w[k] = t;
  }
  return r;
}

__device__ __forceinline__ U256 neg(const U256& a) {
  U256 z = make(0);
  return sub(z, a);
}

__device__ __forceinline__ U256 abs_(const U256& a, bool* was_neg) {
  *was_neg = is_neg(a);
  return *was_neg ? neg(a) : a;
}

// a + v, v in {-1, 0, 1}, sign-extended
__device__ __forceinline__ U256 add_small(const U256& a, int v) {
  U256 b;
  const uint64_t ext = v < 0 ? ~0ull : 0ull;
  b.w[0] = static_cast<uint64_t>(static_cast<int64_t>(v));
  b.w[1] = b.w[2] = b.w[3] = ext;
  return add(a, b);
}

// unsigned a < b
__device__ __forceinline__ bool lt(const U256& a, const U256& b) {
  if (a.w[3] != b.w[3]) return a.w[3] < b.w[3];
  if (a.w[2] != b.w[2]) return a.w[2] < b.w[2];
  if (a.w[1] != b.w[1]) return a.w[1] < b.w[1];
  return a.w[0] < b.w[0];
}

__device__ __forceinline__ U256 shl1(const U256& a) {
  U256 r;
  r.w[3] = (a.w[3] << 1) | (a.w[2] >> 63);
  r.w[2] = (a.w[2] << 1) | (a.w[1] >> 63);
  r.w[1] = (a.w[1] << 1) | (a.w[0] >> 63);
  r.w[0] = a.w[0] << 1;
  return r;
}

// a * b mod 2^256 (decimal_utils.cu:127)
__device__ __forceinline__ U256 mul(const U256& a, const U256& b) {
  U256 r = make(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; i + j < 4; ++j) {
      const uint64_t lo = a.w[i] * b.w[j];
      uint64_t hi = __umul64hi(a.w[i], b.w[j]);
      uint64_t t = r.w[i + j] + lo;
      hi += t < lo;
      t += carry;
      hi += t < carry;
      r.w[i + j] = t;
      carry = hi;
    }
  }
  return r;
}

__device__ __forceinline__ int top_bit(const U256& a) {
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (a.w[k]) return 64 * k + 63 - __clzll(static_cast<long long>(a.w[k]));
  return -1;
}

// The JAX package's binary long division of unsigned n by d
// (int256.divmod_unsigned, decimal_utils.cu:149-169)
__device__ void divmod_u(const U256& n, const U256& d, U256* q, U256* r) {
  if (is_zero(d)) {  // every step subtracts 0
    q->w[0] = q->w[1] = q->w[2] = q->w[3] = ~0ull;
    *r = n;
    return;
  }
  if ((n.w[1] | n.w[2] | n.w[3] | d.w[1] | d.w[2] | d.w[3]) == 0) {
    *q = make(n.w[0] / d.w[0]);
    *r = make(n.w[0] % d.w[0]);
    return;
  }
  U256 qq = make(0), rr = make(0);
#pragma unroll 1  // one step a trip: the SASS loop is one step's work
  for (int i = top_bit(n); i >= 0; --i) {
    rr = shl1(rr);
    rr.w[0] |= (n.w[i >> 6] >> (i & 63)) & 1;
    if (!lt(rr, d)) {
      rr = sub(rr, d);
      qq.w[i >> 6] |= 1ull << (i & 63);
    }
  }
  *q = qq;
  *r = rr;
}

// truncating signed division (decimal_utils.cu:171-191)
__device__ void divmod_s(const U256& n, const U256& d, U256* q, U256* r) {
  bool nn, dn;
  const U256 an = abs_(n, &nn), ad = abs_(d, &dn);
  U256 qq, rr;
  divmod_u(an, ad, &qq, &rr);
  *q = (nn ^ dn) ? neg(qq) : qq;
  *r = nn ? neg(rr) : rr;
}

// HALF_UP from the remainder's magnitude (decimal_utils.cu:193-225)
__device__ __forceinline__ U256 round_rem(const U256& q, const U256& abs_r,
                                          bool n_neg, bool d_neg,
                                          const U256& abs_d) {
  if (lt(shl1(abs_r), abs_d)) return q;
  return add_small(q, (n_neg ^ d_neg) ? -1 : 1);
}

// n / d, HALF_UP (decimal_utils.cu:230-235)
__device__ U256 div_round(const U256& n, const U256& d) {
  bool nn, dn;
  const U256 an = abs_(n, &nn), ad = abs_(d, &dn);
  U256 q, r;
  divmod_u(an, ad, &q, &r);
  if (nn ^ dn) q = neg(q);
  return round_rem(q, r, nn, dn, ad);
}

__device__ __forceinline__ U256 int_div(const U256& n, const U256& d) {
  U256 q, r;
  divmod_s(n, d, &q, &r);
  return q;
}

// smallest i with 10^i >= |v|, 77 past 10^76 (decimal_utils.cu:520-535)
__device__ __forceinline__ int precision10(const U256& v) {
  bool ng;
  const U256 a = abs_(v, &ng);
  int lo = 0, hi = 77;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lt(pow10(mid), a)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ bool gt38(const U256& v) {
  bool ng;
  return !lt(abs_(v, &ng), pow10(38));
}

// rescale between cudf scales (decimal_utils.cu:544-558)
__device__ __forceinline__ U256 rescale(const U256& v, int old_c,
                                        int new_c) {
  if (old_c == new_c) return v;
  if (new_c < old_c) return mul(v, pow10(old_c - new_c));
  return div_round(v, pow10(new_c - old_c));
}

__device__ __forceinline__ U256 load(const int32_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  U256 r;
  r.w[0] = v.x | (static_cast<uint64_t>(v.y) << 32);
  r.w[1] = v.z | (static_cast<uint64_t>(v.w) << 32);
  r.w[2] = r.w[3] = static_cast<uint64_t>(static_cast<int64_t>(r.w[1]) >> 63);
  return r;
}

template <int OP>
__global__ void __launch_bounds__(256)
decimal128_kernel(const int32_t* __restrict__ a, long long sa,
                  const int32_t* __restrict__ b, long long sb, long long n,
                  int a_c, int b_c, int out_c, int cast_interim,
                  void* __restrict__ out, bool* __restrict__ overflow,
                  int* __restrict__ err) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const U256 x = load(a + 4 * sa * i);
  const U256 y = load(b + 4 * sb * i);
  U256 res;
  bool over;
  if (OP == kAdd || OP == kSub) {
    const int inter = a_c < b_c ? a_c : b_c;
    const U256 xs = rescale(x, a_c, inter);
    U256 ys = rescale(y, b_c, inter);
    if (OP == kSub) ys = neg(ys);
    res = rescale(add(xs, ys), inter, out_c);
    over = gt38(res);
  } else if (OP == kMul) {
    U256 p = mul(x, y);
    int mult_scale = a_c + b_c;
    if (cast_interim) {
      int fdp = precision10(p) - 38;
      if (fdp > 0) {
        p = div_round(p, pow10(fdp));
        mult_scale += fdp;
      }
    }
    const int exponent = out_c - mult_scale;
    const bool over_pre = exponent < 0 && precision10(p) - exponent > 38;
    if (exponent < 0) {
      int e = -exponent;
      if (e > 76) {  // the plain version raises; flag it for the wrapper
        if (err) *err = 1;
        e = 76;
      }
      p = mul(p, pow10(e));
    } else if (exponent > 0) {
      p = div_round(p, pow10(exponent));
    }
    res = p;
    over = over_pre || gt38(res);
  } else if (OP == kDiv || OP == kIntDiv) {
    const bool d_zero = is_zero(y);
    const U256 d = d_zero ? make(1) : y;
    const int shift = out_c - (a_c - b_c);
    if (shift > 0) {
      const U256 q1 = int_div(x, d);
      res = OP == kIntDiv ? int_div(q1, pow10(shift))
                          : div_round(q1, pow10(shift));
    } else if (shift < -38) {
      // two-step base-10 long division (decimal_utils.cu:796-826)
      U256 q1, r1;
      divmod_s(mul(x, pow10(38)), d, &q1, &r1);
      const U256 rem = pow10(-shift - 38);
      const U256 scaled_r = mul(r1, rem);
      U256 q2, r2;
      divmod_s(scaled_r, d, &q2, &r2);
      res = add(mul(q1, rem), q2);
      if (OP == kDiv) {
        bool dn, rn;
        const U256 ad = abs_(d, &dn);
        const U256 ar = abs_(r2, &rn);
        res = round_rem(res, ar, is_neg(scaled_r), dn, ad);
      }
    } else {
      const U256 nn = shift < 0 ? mul(x, pow10(-shift)) : x;
      res = OP == kIntDiv ? int_div(nn, d) : div_round(nn, d);
    }
    over = gt38(res) || d_zero;
    if (d_zero) res = make(0);
  } else {  // kRem: a - (a // b) * b (decimal_utils.cu:854-968)
    const bool d_zero = is_zero(y);
    const U256 d = d_zero ? make(1) : y;
    const int d_shift = out_c - b_c;
    int n_shift = out_c - a_c;
    bool dn, nn;
    U256 ad = abs_(d, &dn);
    if (d_shift > 0) ad = div_round(ad, pow10(d_shift));
    else n_shift -= d_shift;
    U256 an = abs_(x, &nn);
    U256 q;
    if (n_shift > 0) {
      U256 q1, r1;
      divmod_u(an, ad, &q1, &r1);
      q = int_div(q1, pow10(n_shift));
    } else {
      if (n_shift < 0) an = mul(an, pow10(-n_shift));
      U256 r1;
      divmod_u(an, ad, &q, &r1);
    }
    U256 less = mul(q, ad);
    if (d_shift < 0) less = mul(less, pow10(-d_shift));
    res = sub(an, less);
    over = gt38(res) || d_zero;
    if (nn) res = neg(res);
    if (d_zero) res = make(0);
  }
  overflow[i] = over;
  if (OP == kIntDiv) {
    static_cast<long long*>(out)[i] = static_cast<long long>(res.w[0]);
  } else {
    uint4 v;
    v.x = static_cast<uint32_t>(res.w[0]);
    v.y = static_cast<uint32_t>(res.w[0] >> 32);
    v.z = static_cast<uint32_t>(res.w[1]);
    v.w = static_cast<uint32_t>(res.w[1] >> 32);
    reinterpret_cast<uint4*>(out)[i] = v;
  }
}

template <int OP>
int launch(const int32_t* a, long long sa, const int32_t* b, long long sb,
           long long n, int a_c, int b_c, int out_c, int cast_interim,
           void* out, bool* overflow, int* err, cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  decimal128_kernel<OP><<<(unsigned)blocks, 256, 0, stream>>>(
      a, sa, b, sb, n, a_c, b_c, out_c, cast_interim, out, overflow, err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* srjt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a, b: int32[n, 4] limbs, 16-byte aligned, row strides sa, sb in rows (1,
// or 0 for a literal); out: int32[n, 4] (int64[n] for integer divide);
// overflow: bool[n]; err: null or one int on the card. Returns
// cudaGetLastError() after the launch (0 = launched).
int srjt_decimal128_op(int op, const int32_t* a, long long sa,
                       const int32_t* b, long long sb, long long n, int a_c,
                       int b_c, int out_c, int cast_interim, void* out,
                       bool* overflow, int* err, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd:
      return launch<kAdd>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim,
                          out, overflow, err, s);
    case kSub:
      return launch<kSub>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim,
                          out, overflow, err, s);
    case kMul:
      return launch<kMul>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim,
                          out, overflow, err, s);
    case kDiv:
      return launch<kDiv>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim,
                          out, overflow, err, s);
    case kIntDiv:
      return launch<kIntDiv>(a, sa, b, sb, n, a_c, b_c, out_c,
                             cast_interim, out, overflow, err, s);
    case kRem:
      return launch<kRem>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim,
                          out, overflow, err, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
