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
// Bound: bytes, 2 x 16 B read and 17 B written a row (9 B for integer
// divide), for every op at the shapes Spark's decimal queries give it
// (18-digit values by 9-digit ones, chip_smoke.py phase 11d): a division
// costs a per-row reciprocal and one digit step per 64-bit word of the
// quotient, about 150 instructions, and a row's whole work stays under its
// bytes' time at the card's issue rate. Phase 11d counts the reciprocals,
// steps and hardware divisions its data takes, at the fewest instructions
// the SASS gives each (the h2_probe_* kernels below, never launched, hold
// one of each for that count), and times each op against that bound.
//
// Design: one thread a row, every value in registers: a 256-bit value is
// four 64-bit words, only ever indexed by constants (unrolled loops), and
// every helper is inlined, so nothing goes to the stack. Where no value
// can wrap mod 2^256, an op works on magnitudes (a 128-bit operand is two
// words) and takes the sign last, and a product multiplies only the words
// its factors can have (mul_n); wrapping products keep the full 256-bit
// arithmetic. The powers of ten 10^0..10^76 are a table in constant memory
// (2.4 KB); precision10 compares with at most two of them, picked by the
// value's top bit. Division is Knuth's Algorithm D (TAOCP vol. 2, 4.3.1)
// in 64-bit digits on the magnitudes: n and d are shifted left by d's
// leading zeros (n gains a fifth word), then each quotient digit comes
// from a 2-by-1 division (one-word divisor) or a 3-by-2 division of the
// top words (longer divisors) by a reciprocal of the normalised divisor's
// top word(s), with Moller and Granlund's algorithms ("Improved division
// by invariant integers", IEEE TC 2011: the reciprocal, its 3-by-2
// adjustment, the 2-by-1 and 3-by-2 steps, as GMP writes them). Their
// rare corrections and Algorithm D's add-back are selects, not branches;
// a digit step is skipped where the numerator has no word for it. A
// divisor from the data (two words at most) gets its reciprocal once per
// row; a power of ten 10^e (1 to 4 words) reads its reciprocal and shift
// from kPow10Inv, for rescales, the interim cast and the second division
// of divide, integer divide and remainder. Where n and d both fit one
// word, the hardware's 64-bit division runs: on the card it beats a
// reciprocal and a 2-by-1 step there (PERF.md).
//
// Edges: d == 0 gives a quotient of all ones and the remainder n, as the
// bit-serial loop does. No entry point divides by 2^255 or more, so that
// loop's wrap for such a divisor never occurs: a divisor from the data is
// a 128-bit magnitude (at most 2^127) or remainder's |b| rescaled down,
// and a power of ten is below 2^253. divmod_u still gives the loop's
// result for every divisor: one of 2^128 or more, which no entry point
// passes it, runs the bit-serial loop itself, in registers.
//
// Built by nvcc for the card; built by a C++ compiler for the host
// (without __CUDACC__), the same per-row arithmetic runs on the CPU for
// the tests, with counts of each division branch (H2_COUNT).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define H2_FN __device__ __forceinline__
#define H2_TABLE __constant__
#define H2_COUNT(k) ((void)0)
#else
#include <string.h>
#define H2_FN static inline
#define H2_TABLE static const
#define H2_COUNT(k) (++h2_counts[k])
#endif

namespace {

enum Op { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3, kIntDiv = 4, kRem = 5 };

// the division's branches, counted by the host build (tests)
enum Count {
  kZeroDivisor = 0,   // d == 0
  kBitSerial,         // d >= 2^128 from the data: the bit-serial loop
  kShortHw,           // one word by one word, the hardware's division
  kFewerWords,        // n has fewer words than d: q = 0, r = n
  kFix2by1a,          // 2-by-1: q one too large (the select)
  kFix2by1b,          // 2-by-1: q one too small (the rare one)
  kFix3by2a,          // 3-by-2: q one too large
  kFix3by2b,          // 3-by-2: q one too small
  kTopEqual,          // Algorithm D: top words equal d's, digit 2^64 - 1
  kAddBack,           // Algorithm D: q one too large, d added back
  kRecip3by2a,        // the 3-by-2 reciprocal's first adjustment
  kRecip3by2b,        // its second
  kRecip3by2c,        // its third
  kPow10Division,     // a division by 10^e from the table
  kPairs,             // + 4 * (numerator words) + divisor words - 1:
                      // a division of n by d in 64-bit words
  kNumCounts = kPairs + 20
};

#ifndef __CUDACC__
static long long h2_counts[kNumCounts];
#endif

struct U256 {
  uint64_t w[4];  // little-endian 64-bit words
};

H2_TABLE uint64_t kPow10[77][4] = {
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

// the reciprocal of each power of ten and its shift: v = floor((2^128 -
// 1) / (10^e << s)) - 2^64 for 10^e < 2^64, else Moller and Granlund's
// 3-by-2 reciprocal of the top two words of 10^e << s; s = the leading
// zeros of 10^e's top word
struct Pow10Inv {
  uint64_t v;
  int shift;
};

H2_TABLE Pow10Inv kPow10Inv[77] = {
    {0xffffffffffffffffull, 63},  // 1e0
    {0x9999999999999999ull, 60},  // 1e1
    {0x47ae147ae147ae14ull, 57},  // 1e2
    {0x0624dd2f1a9fbe76ull, 54},  // 1e3
    {0xa36e2eb1c432ca57ull, 50},  // 1e4
    {0x4f8b588e368f0846ull, 47},  // 1e5
    {0x0c6f7a0b5ed8d36bull, 44},  // 1e6
    {0xad7f29abcaf48578ull, 40},  // 1e7
    {0x5798ee2308c39df9ull, 37},  // 1e8
    {0x12e0be826d694b2eull, 34},  // 1e9
    {0xb7cdfd9d7bdbab7dull, 30},  // 1e10
    {0x5fd7fe17964955fdull, 27},  // 1e11
    {0x19799812dea11197ull, 24},  // 1e12
    {0xc25c268497681c26ull, 20},  // 1e13
    {0x6849b86a12b9b01eull, 17},  // 1e14
    {0x203af9ee756159b2ull, 14},  // 1e15
    {0xcd2b297d889bc2b6ull, 10},  // 1e16
    {0x70ef54646d496892ull,  7},  // 1e17
    {0x2725dd1d243aba0eull,  4},  // 1e18
    {0xd83c94fb6d2ac34aull,  0},  // 1e19
    {0x79ca10c9242235d5ull, 61},  // 1e20
    {0x2e3b40a0e9b4f7ddull, 58},  // 1e21
    {0xe392010175ee5962ull, 54},  // 1e22
    {0x82db34012b25144eull, 51},  // 1e23
    {0x357c299a88ea76a5ull, 48},  // 1e24
    {0xef2d0f5da7dd8aa2ull, 44},  // 1e25
    {0x8c240c4aecb13bb5ull, 41},  // 1e26
    {0x3ce9a36f23c0fc90ull, 38},  // 1e27
    {0xfb0f6be50601941bull, 34},  // 1e28
    {0x95a5efea6b34767cull, 31},  // 1e29
    {0x4484bfeebc29f863ull, 28},  // 1e30
    {0x039d66589687f9e9ull, 25},  // 1e31
    {0x9f623d5a8a732974ull, 21},  // 1e32
    {0x4c4e977ba1f5bac3ull, 18},  // 1e33
    {0x09d8792fb4c49569ull, 15},  // 1e34
    {0xa95a5b7f87a0ef0full, 11},  // 1e35
    {0x54484932d2e725a5ull,  8},  // 1e36
    {0x1039d428a8b8eaeaull,  5},  // 1e37
    {0xb38fb9daa78e44abull,  1},  // 1e38
    {0x5c72fb1552d836efull, 62},  // 1e39
    {0x16c262777579c58cull, 59},  // 1e40
    {0xbe03d0bf225c6f46ull, 55},  // 1e41
    {0x64cfda3281e38c38ull, 52},  // 1e42
    {0x1d7314f534b609c6ull, 49},  // 1e43
    {0xc8b821885456760bull, 45},  // 1e44
    {0x6d601ad376ab91a2ull, 42},  // 1e45
    {0x244ce242c5560e1bull, 39},  // 1e46
    {0xd3ae36d13bbce35full, 35},  // 1e47
    {0x7624f8a762fd82b2ull, 32},  // 1e48
    {0x2b50c6ec4f31355bull, 29},  // 1e49
    {0xdee7a4ad4b81eef9ull, 25},  // 1e50
    {0x7f1fb6f10934bf2dull, 22},  // 1e51
    {0x327fc58da0f6ff57ull, 19},  // 1e52
    {0xea6608e29b24cbbfull, 15},  // 1e53
    {0x8851a0b548ea3c99ull, 12},  // 1e54
    {0x39dae6f76d88307aull,  9},  // 1e55
    {0xf62b0b257c0d1a5dull,  5},  // 1e56
    {0x91bc08eac9a41517ull,  2},  // 1e57
    {0x41633a556e1cddacull, 63},  // 1e58
    {0x011c2eaabe7d7e23ull, 60},  // 1e59
    {0x9b604aaaca62636cull, 56},  // 1e60
    {0x4919d5556eb51c56ull, 53},  // 1e61
    {0x0747ddddf22a7d12ull, 50},  // 1e62
    {0xa53fc9631d10c81dull, 46},  // 1e63
    {0x50ffd44f4a73d34aull, 43},  // 1e64
    {0x0d9976a5d52975d5ull, 40},  // 1e65
    {0xaf5bf109550f22eeull, 36},  // 1e66
    {0x59165a6ddda5b58bull, 33},  // 1e67
    {0x1411e1f17e1e2ad6ull, 30},  // 1e68
    {0xb9b6364f30304489ull, 26},  // 1e69
    {0x615e91d8f359d06eull, 23},  // 1e70
    {0x1ab20e472914a6beull, 20},  // 1e71
    {0xc45016d841baa464ull, 16},  // 1e72
    {0x69d9abe034955050ull, 13},  // 1e73
    {0x217aefe690777373ull, 10},  // 1e74
    {0xcf2b1970e7258585ull,  6},  // 1e75
    {0x7288e1271f51379dull,  3},  // 1e76
};

H2_FN uint64_t mulhi(uint64_t a, uint64_t b) {
#ifdef __CUDACC__
  return __umul64hi(a, b);
#else
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

H2_FN int clz64(uint64_t x) {
#ifdef __CUDACC__
  return __clzll(static_cast<long long>(x));
#else
  return x ? __builtin_clzll(x) : 64;
#endif
}

H2_FN U256 make(uint64_t lo) {
  U256 r;
  r.w[0] = lo;
  r.w[1] = r.w[2] = r.w[3] = 0;
  return r;
}

H2_FN U256 pow10(int e) {
  U256 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.w[k] = kPow10[e][k];
  return r;
}

H2_FN bool is_neg(const U256& a) { return (a.w[3] >> 63) != 0; }

H2_FN bool is_zero(const U256& a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

H2_FN U256 add(const U256& a, const U256& b) {
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

H2_FN U256 sub(const U256& a, const U256& b) {
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

H2_FN U256 neg(const U256& a) { return sub(make(0), a); }

H2_FN U256 abs_(const U256& a, bool* was_neg) {
  *was_neg = is_neg(a);
  return *was_neg ? neg(a) : a;
}

// a + v, v in {-1, 0, 1}, sign-extended
H2_FN U256 add_small(const U256& a, int v) {
  U256 b;
  const uint64_t ext = v < 0 ? ~0ull : 0ull;
  b.w[0] = static_cast<uint64_t>(static_cast<int64_t>(v));
  b.w[1] = b.w[2] = b.w[3] = ext;
  return add(a, b);
}

// unsigned a < b
H2_FN bool lt(const U256& a, const U256& b) {
  if (a.w[3] != b.w[3]) return a.w[3] < b.w[3];
  if (a.w[2] != b.w[2]) return a.w[2] < b.w[2];
  if (a.w[1] != b.w[1]) return a.w[1] < b.w[1];
  return a.w[0] < b.w[0];
}

H2_FN U256 shl1(const U256& a) {
  U256 r;
  r.w[3] = (a.w[3] << 1) | (a.w[2] >> 63);
  r.w[2] = (a.w[2] << 1) | (a.w[1] >> 63);
  r.w[1] = (a.w[1] << 1) | (a.w[0] >> 63);
  r.w[0] = a.w[0] << 1;
  return r;
}

// a * b mod 2^256 (decimal_utils.cu:127), where a has NA words and b NB
// words (the words above them zero): the partial products that reach the
// low four words only
template <int NA, int NB>
H2_FN U256 mul_n(const U256& a, const U256& b) {
  U256 r = make(0);
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NB && i + j < 4; ++j) {
      const uint64_t lo = a.w[i] * b.w[j];
      uint64_t hi = mulhi(a.w[i], b.w[j]);
      uint64_t t = r.w[i + j] + lo;
      hi += t < lo;
      t += carry;
      hi += t < carry;
      r.w[i + j] = t;
      carry = hi;
    }
    if (i + NB < 4) r.w[i + NB] = carry;  // a word no row wrote yet
  }
  return r;
}

H2_FN U256 mul(const U256& a, const U256& b) { return mul_n<4, 4>(a, b); }

// a * 10^e mod 2^256 for a of NA words, by the words 10^e has
template <int NA>
H2_FN U256 mul_pow10(const U256& a, int e) {
  const U256 p = pow10(e);
  if (e <= 19) return mul_n<NA, 1>(a, p);
  if (e <= 38) return mul_n<NA, 2>(a, p);
  if (e <= 57) return mul_n<NA, 3>(a, p);
  return mul_n<NA, 4>(a, p);
}

// |a| of a 128-bit value sign-extended to 256 bits (two words; -2^127
// gives 2^127), and its sign
H2_FN U256 abs128(const U256& a, bool* was_neg) {
  *was_neg = is_neg(a);
  U256 r = make(0);
  r.w[0] = *was_neg ? 0 - a.w[0] : a.w[0];
  r.w[1] = *was_neg ? 0 - a.w[1] - (a.w[0] != 0) : a.w[1];
  return r;
}

// a 128-bit value times 10^e mod 2^256, in its magnitude
H2_FN U256 scale_up128(const U256& a, int e) {
  bool an;
  const U256 m = mul_pow10<2>(abs128(a, &an), e);
  return an ? neg(m) : m;
}

// ---- division -------------------------------------------------------------

// the words of a (0..4)
H2_FN int words(const U256& a) {
  return a.w[3] ? 4 : a.w[2] ? 3 : a.w[1] ? 2 : a.w[0] ? 1 : 0;
}

// x >> (64 - s) for 0 <= s < 64 (0 where s == 0)
H2_FN uint64_t spill_bits(uint64_t x, int s) { return (x >> 1) >> (63 - s); }

// floor((2^128 - 1) / d) - 2^64 for 2^63 <= d < 2^64 (Moller and
// Granlund, Algorithm 4; the 11-bit start v0 is their table's entry,
// computed in float)
H2_FN uint64_t reciprocal_2by1(uint64_t d) {
  const uint64_t d0 = d & 1, d40 = (d >> 24) + 1;
  const uint64_t d63 = (d >> 1) + d0;
  // v0 = floor(523520 / d9), d9 = d >> 55 in [256, 511]: the float
  // quotient is within 2.5e-4 of the exact one, which is an integer or at
  // least 1 / 511 away from one, so the float plus 0.001 truncates to it
  const float d9 = static_cast<float>(static_cast<uint32_t>(d >> 55));
#ifdef __CUDACC__
  const float f = __fdividef(523520.0f, d9);
#else
  const float f = 523520.0f / d9;
#endif
  const uint32_t v0 = static_cast<uint32_t>(f + 0.001f);
  const uint64_t v0sq = static_cast<uint64_t>(v0) * v0;
  const uint32_t v1 = static_cast<uint32_t>(
      (static_cast<uint64_t>(v0) << 11) - ((v0sq * d40) >> 40) - 1);
  const uint64_t v1w = v1;  // v1 < 2^22: 32-bit products
  const uint64_t v2 = (v1w << 13) + ((v1w * ((1ull << 60) - v1w * d40)) >> 47);
  const uint64_t e = ((v2 >> 1) & (0 - d0)) - v2 * d63;
  const uint64_t v3 = (v2 << 31) + (mulhi(v2, e) >> 1);
  uint64_t lo = v3 * d, hi = mulhi(v3, d);
  lo += d;
  hi += d + (lo < d);
  return v3 - hi;
}

// floor((2^192 - 1) / (d1 2^64 + d0)) - 2^64 for d1 >= 2^63, from v, the
// 2-by-1 reciprocal of d1 (Moller and Granlund, Algorithm 6; GMP's
// invert_pi1)
H2_FN uint64_t reciprocal_3by2(uint64_t v, uint64_t d1, uint64_t d0) {
  uint64_t p = d1 * v + d0;
  if (p < d0) {
    H2_COUNT(kRecip3by2a);
    --v;
    const uint64_t mask = p >= d1 ? ~0ull : 0ull;
    p -= d1;
    v += mask;
    p -= mask & d1;
  }
  const uint64_t t0 = d0 * v, t1 = mulhi(d0, v);
  p += t1;
  if (p < t1) {
    H2_COUNT(kRecip3by2b);
    --v;
    if (p >= d1 && (p > d1 || t0 >= d0)) {
      H2_COUNT(kRecip3by2c);
      --v;
    }
  }
  return v;
}

// (u1 2^64 + u0) / d for u1 < d, d >= 2^63, v = reciprocal_2by1(d): the
// quotient, the remainder in *r (Moller and Granlund, Algorithm 4's
// division; GMP's udiv_qrnnd_preinv)
H2_FN uint64_t div_2by1(uint64_t u1, uint64_t u0, uint64_t d, uint64_t v,
                        uint64_t* r) {
  uint64_t q0 = v * u1, q1 = mulhi(v, u1);
  q0 += u0;
  q1 += u1 + 1 + (q0 < u0);
  uint64_t rr = u0 - q1 * d;
  const bool over = rr > q0;
  if (over) H2_COUNT(kFix2by1a);
  q1 -= over;
  rr += over ? d : 0;
  const bool under = rr >= d;
  if (under) H2_COUNT(kFix2by1b);
  q1 += under;
  rr -= under ? d : 0;
  *r = rr;
  return q1;
}

// (u2, u1, u0) / (d1, d0) for (u2, u1) < (d1, d0), d1 >= 2^63, v =
// reciprocal_3by2(d1, d0): the quotient, the remainder in (*r1, *r0)
// (Moller and Granlund, Algorithm 5; GMP's udiv_qr_3by2)
H2_FN uint64_t div_3by2(uint64_t u2, uint64_t u1, uint64_t u0, uint64_t d1,
                        uint64_t d0, uint64_t v, uint64_t* r1,
                        uint64_t* r0) {
  uint64_t q0 = v * u2, q = mulhi(v, u2);
  q0 += u1;
  q += u2 + (q0 < u1);
  uint64_t a1 = u1 - d1 * q;
  uint64_t a0 = u0 - d0;
  a1 = a1 - d1 - (u0 < d0);
  const uint64_t t0 = d0 * q, t1 = mulhi(d0, q);
  const uint64_t b = a0 < t0;
  a0 -= t0;
  a1 = a1 - t1 - b;
  ++q;
  const bool over = a1 >= q0;
  if (over) H2_COUNT(kFix3by2a);
  q -= over;
  const uint64_t m = over ? ~0ull : 0ull;
  a0 += d0 & m;
  a1 += (d1 & m) + (a0 < (d0 & m));
  const bool under = a1 > d1 || (a1 == d1 && a0 >= d0);
  if (under) H2_COUNT(kFix3by2b);
  q += under;
  const uint64_t mu = under ? ~0ull : 0ull;
  const uint64_t bu = a0 < (d0 & mu);
  a0 -= d0 & mu;
  a1 -= (d1 & mu) + bu;
  *r1 = a1;
  *r0 = a0;
  return q;
}

// a divisor ready for Algorithm D: d << s (its top bit set), its words k,
// the shift s and the reciprocal v of its top word(s)
struct Divisor {
  U256 dn;
  uint64_t v;
  int s, k;
};

// a << s, 0 <= s < 64, where the top s bits of a are zero
H2_FN U256 shl_fit(const U256& a, int s) {
  U256 r;
  r.w[3] = (a.w[3] << s) | spill_bits(a.w[2], s);
  r.w[2] = (a.w[2] << s) | spill_bits(a.w[1], s);
  r.w[1] = (a.w[1] << s) | spill_bits(a.w[0], s);
  r.w[0] = a.w[0] << s;
  return r;
}

// 0 < d < 2^128, from the data: its reciprocal, once per row
H2_FN Divisor data_divisor(const U256& d) {
  Divisor D;
  D.k = d.w[1] ? 2 : 1;
  D.s = clz64(d.w[1] ? d.w[1] : d.w[0]);
  D.dn = shl_fit(d, D.s);
  if (D.k == 1) {
    D.v = reciprocal_2by1(D.dn.w[0]);
  } else {
    D.v = reciprocal_3by2(reciprocal_2by1(D.dn.w[1]), D.dn.w[1], D.dn.w[0]);
  }
  return D;
}

// 10^e: its reciprocal and shift from the table
H2_FN Divisor pow10_divisor(int e) {
  Divisor D;
  D.k = 1 + (e > 19) + (e > 38) + (e > 57);
  D.s = kPow10Inv[e].shift;
  D.v = kPow10Inv[e].v;
  D.dn = shl_fit(pow10(e), D.s);
  return D;
}

// Algorithm D of n by a divisor of K words: q = n / d, r = n % d
template <int K>
H2_FN void divmod_norm(const U256& n, const Divisor& D, U256* q,
                       U256* r) {
  const int nw = words(n);
  H2_COUNT(kPairs + 4 * nw + K - 1);
  if (nw < K) {
    H2_COUNT(kFewerWords);
    *q = make(0);
    *r = n;
    return;
  }
  const int s = D.s;
  uint64_t u[5];  // n << s
  u[4] = spill_bits(n.w[3], s);
#pragma unroll
  for (int k = 3; k > 0; --k) u[k] = (n.w[k] << s) | spill_bits(n.w[k - 1], s);
  u[0] = n.w[0] << s;
  U256 qq = make(0);
#pragma unroll
  for (int j = 4 - K; j >= 0; --j) {
    if (j > nw - K) continue;  // above the quotient's top digit
    uint64_t qh;
    if (K == 1) {
      qh = div_2by1(u[j + 1], u[j], D.dn.w[0], D.v, &u[j]);
    } else if (K == 2) {
      qh = div_3by2(u[j + 2], u[j + 1], u[j], D.dn.w[1], D.dn.w[0], D.v,
                    &u[j + 1], &u[j]);
    } else {
      const uint64_t n2 = u[j + K], n1 = u[j + K - 1], n0 = u[j + K - 2];
      const uint64_t d1 = D.dn.w[K - 1], d0 = D.dn.w[K - 2];
      if (n2 == d1 && n1 == d0) {
        // the window's top words equal d's: its digit is 2^64 - 1 (the
        // window is at least d (2^64 - 1), below d 2^64)
        H2_COUNT(kTopEqual);
        qh = ~0ull;
        uint64_t cy = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          uint64_t lo = qh * D.dn.w[i];
          uint64_t hi = mulhi(qh, D.dn.w[i]);
          lo += cy;
          hi += lo < cy;
          const uint64_t b = u[j + i] < lo;
          u[j + i] -= lo;
          cy = hi + b;
        }
      } else {
        uint64_t r1, r0;
        qh = div_3by2(n2, n1, n0, d1, d0, D.v, &r1, &r0);
        uint64_t cy = 0;  // u[j .. j + K - 3] -= qh * d's low words
#pragma unroll
        for (int i = 0; i < K - 2; ++i) {
          uint64_t lo = qh * D.dn.w[i];
          uint64_t hi = mulhi(qh, D.dn.w[i]);
          lo += cy;
          hi += lo < cy;
          const uint64_t b = u[j + i] < lo;
          u[j + i] -= lo;
          cy = hi + b;
        }
        const uint64_t b0 = r0 < cy;
        r0 -= cy;
        const uint64_t b1 = r1 < b0;
        r1 -= b0;
        u[j + K - 2] = r0;
        u[j + K - 1] = r1;
        // q one too large: the window went below 0; add d back
        if (b1) H2_COUNT(kAddBack);
        qh -= b1;
        const uint64_t m = b1 ? ~0ull : 0ull;
        uint64_t c = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const uint64_t a = D.dn.w[i] & m;
          const uint64_t t = u[j + i] + a;
          const uint64_t t2 = t + c;
          c = (t < a) | (t2 < t);
          u[j + i] = t2;
        }
      }
    }
    u[j + K] = 0;
    qq.w[j] = qh;
  }
  U256 rr;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rr.w[k] = k >= K ? 0
              : (u[k] >> s) | (k + 1 < K ? (u[k + 1] << 1) << (63 - s) : 0);
  }
  *q = qq;
  *r = rr;
}

// the JAX package's bit-serial long division (int256.divmod_unsigned,
// decimal_utils.cu:149-169), all 256 steps, words shifted in registers
H2_FN void divmod_bits(const U256& n, const U256& d, U256* q, U256* r) {
  U256 nn = n, qq = make(0), rr = make(0);
#pragma unroll 1
  for (int i = 0; i < 256; ++i) {
    rr = shl1(rr);
    rr.w[0] |= nn.w[3] >> 63;
    nn = shl1(nn);
    const bool ge = !lt(rr, d);
    if (ge) rr = sub(rr, d);
    qq = shl1(qq);
    qq.w[0] |= ge;
  }
  *q = qq;
  *r = rr;
}

// unsigned n / d with the bit-serial loop's results everywhere (d == 0:
// quotient all ones, remainder n)
H2_FN void divmod_u(const U256& n, const U256& d, U256* q, U256* r) {
  if (is_zero(d)) {  // every step of the loop subtracts 0
    H2_COUNT(kZeroDivisor);
    q->w[0] = q->w[1] = q->w[2] = q->w[3] = ~0ull;
    *r = n;
    return;
  }
  if (d.w[2] | d.w[3]) {  // no entry point divides by such a value
    H2_COUNT(kBitSerial);
    divmod_bits(n, d, q, r);
    return;
  }
  if ((n.w[1] | n.w[2] | n.w[3] | d.w[1]) == 0) {  // one word by one word
    H2_COUNT(kShortHw);
    H2_COUNT(kPairs + 4 * (n.w[0] != 0) + 0);
    *q = make(n.w[0] / d.w[0]);
    *r = make(n.w[0] % d.w[0]);
    return;
  }
  const Divisor D = data_divisor(d);
  if (D.k == 1) divmod_norm<1>(n, D, q, r);
  else divmod_norm<2>(n, D, q, r);
}

// unsigned n / 10^e, 0 <= e <= 76
H2_FN void divmod_pow10(const U256& n, int e, U256* q, U256* r) {
  H2_COUNT(kPow10Division);
  const Divisor D = pow10_divisor(e);
  switch (D.k) {
    case 1: divmod_norm<1>(n, D, q, r); break;
    case 2: divmod_norm<2>(n, D, q, r); break;
    case 3: divmod_norm<3>(n, D, q, r); break;
    default: divmod_norm<4>(n, D, q, r); break;
  }
}

// truncating signed division (decimal_utils.cu:171-191)
H2_FN void divmod_s(const U256& n, const U256& d, U256* q, U256* r) {
  bool nn, dn;
  const U256 an = abs_(n, &nn), ad = abs_(d, &dn);
  U256 qq, rr;
  divmod_u(an, ad, &qq, &rr);
  *q = (nn ^ dn) ? neg(qq) : qq;
  *r = nn ? neg(rr) : rr;
}

// HALF_UP from the remainder's magnitude (decimal_utils.cu:193-225)
H2_FN U256 round_rem(const U256& q, const U256& abs_r, bool n_neg,
                     bool d_neg, const U256& abs_d) {
  if (lt(shl1(abs_r), abs_d)) return q;
  return add_small(q, (n_neg ^ d_neg) ? -1 : 1);
}

// m / 10^e, HALF_UP, for a magnitude m
H2_FN U256 div_round_pow10_mag(const U256& m, int e) {
  U256 q, r;
  divmod_pow10(m, e, &q, &r);
  return lt(shl1(r), pow10(e)) ? q : add_small(q, 1);
}

// n / 10^e, HALF_UP
H2_FN U256 div_round_pow10(const U256& n, int e) {
  bool nn;
  const U256 q = div_round_pow10_mag(abs_(n, &nn), e);
  return nn ? neg(q) : q;
}

// smallest i with 10^i >= m, 77 past 10^76 (decimal_utils.cu:520-535),
// for a magnitude m: from m's top bit t, i0 = floor(t 1233 / 4096) <=
// t log10(2), so 10^i0 <= m, and the answer is at most i0 + 2
H2_FN int precision10_mag(const U256& m) {
  const int top = m.w[3] ? 192 + 63 - clz64(m.w[3])
                  : m.w[2] ? 128 + 63 - clz64(m.w[2])
                  : m.w[1] ? 64 + 63 - clz64(m.w[1])
                  : 63 - clz64(m.w[0]);  // -1 for m == 0
  if (top < 0) return 0;
  const int i0 = (top * 1233) >> 12;
  int i = i0 + lt(pow10(i0), m);
  if (i > i0 && i0 < 76) i += lt(pow10(i0 + 1), m);
  return i;
}

H2_FN bool gt38(const U256& v) {
  bool ng;
  return !lt(abs_(v, &ng), pow10(38));
}

// rescale between cudf scales (decimal_utils.cu:544-558)
H2_FN U256 rescale(const U256& v, int old_c, int new_c) {
  if (old_c == new_c) return v;
  if (new_c < old_c) return mul(v, pow10(old_c - new_c));
  return div_round_pow10(v, new_c - old_c);
}

// one row of op OP on a and b: *res (the low 64 bits for integer divide),
// *over; *err = 1 where a power of ten past 10^76 was asked for. Where
// no value can wrap mod 2^256, the work runs on magnitudes (a 128-bit
// operand is two words, a product of two 256 bits at most) and takes
// the sign last, which is the plain version's result bit for bit.
template <int OP>
H2_FN void row_op(const U256& x, const U256& y, int a_c, int b_c,
                  int out_c, int cast_interim, U256* res_out,
                  bool* over_out, int* err) {
  U256 res;
  bool over;
  if (OP == kAdd || OP == kSub) {
    // to the finer scale: a rescale that only multiplies
    const int inter = a_c < b_c ? a_c : b_c;
    const U256 xs = a_c == inter ? x : scale_up128(x, a_c - inter);
    U256 ys = b_c == inter ? y : scale_up128(y, b_c - inter);
    if (OP == kSub) ys = neg(ys);
    res = rescale(add(xs, ys), inter, out_c);
    over = gt38(res);
  } else if (OP == kMul) {
    bool xn, yn;
    U256 m = mul_n<2, 2>(abs128(x, &xn), abs128(y, &yn));  // < 2^254
    int mult_scale = a_c + b_c;
    if (cast_interim) {
      const int fdp = precision10_mag(m) - 38;
      if (fdp > 0) {
        m = div_round_pow10_mag(m, fdp);
        mult_scale += fdp;
      }
    }
    const int exponent = out_c - mult_scale;
    const bool over_pre = exponent < 0 && precision10_mag(m) - exponent > 38;
    if (exponent < 0) {
      int e = -exponent;
      if (e > 76) {  // the plain version raises; flag it for the wrapper
        if (err) *err = 1;
        e = 76;
      }
      m = mul_pow10<4>(m, e);  // mod 2^256, as the plain version
    } else if (exponent > 0) {
      m = div_round_pow10_mag(m, exponent);
    }
    res = xn ^ yn ? neg(m) : m;
    over = over_pre || gt38(res);
  } else if (OP == kDiv || OP == kIntDiv) {
    const bool d_zero = is_zero(y);
    const int shift = out_c - (a_c - b_c);
    if (shift < -38) {
      // two-step base-10 long division (decimal_utils.cu:796-826)
      const U256 d = d_zero ? make(1) : y;
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
      over = gt38(res) || d_zero;
    } else {
      // |a| / |b| (then / 10^shift) or |a| 10^-shift / |b|: below 2^254
      bool xn, dn = false;
      const U256 xm = abs128(x, &xn);
      const U256 dm = d_zero ? make(1) : abs128(y, &dn);
      U256 m, r;
      if (shift > 0) {
        U256 q1;
        divmod_u(xm, dm, &q1, &r);
        divmod_pow10(q1, shift, &m, &r);
        if (OP == kDiv && !lt(shl1(r), pow10(shift))) m = add_small(m, 1);
      } else {
        divmod_u(shift < 0 ? mul_pow10<2>(xm, -shift) : xm, dm, &m, &r);
        if (OP == kDiv && !lt(shl1(r), dm)) m = add_small(m, 1);
      }
      over = !lt(m, pow10(38)) || d_zero;
      res = xn ^ dn ? neg(m) : m;
    }
    if (d_zero) res = make(0);
  } else {  // kRem: a - (a // b) * b (decimal_utils.cu:854-968)
    const bool d_zero = is_zero(y);
    const int d_shift = out_c - b_c;
    int n_shift = out_c - a_c;
    bool dn = false, nn;
    U256 ad = d_zero ? make(1) : abs128(y, &dn);  // two words
    if (d_shift > 0) ad = div_round_pow10_mag(ad, d_shift);
    else n_shift -= d_shift;
    U256 an = abs128(x, &nn);
    U256 q, r, less;
    if (n_shift > 0) {
      U256 q1;
      divmod_u(an, ad, &q1, &r);  // all ones where ad is 0, else < 2^128
      // (a // b) / 10^n_shift, truncated: 0 where ad is 0 (-1 / 10^n)
      divmod_pow10(is_zero(ad) ? make(0) : q1, n_shift, &q, &r);
      less = mul_n<2, 2>(q, ad);
    } else {
      if (n_shift < 0) an = mul_pow10<2>(an, -n_shift);  // mod 2^256
      divmod_u(an, ad, &q, &r);
      less = mul_n<4, 2>(q, ad);
    }
    if (d_shift < 0) less = mul_pow10<4>(less, -d_shift);
    res = sub(an, less);
    over = gt38(res) || d_zero;
    if (nn) res = neg(res);
    if (d_zero) res = make(0);
  }
  *res_out = res;
  *over_out = over;
}

// a row's int32[4] limbs, sign-extended to 256 bits
H2_FN U256 from_limbs(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  U256 r;
  r.w[0] = x | (static_cast<uint64_t>(y) << 32);
  r.w[1] = z | (static_cast<uint64_t>(w) << 32);
  r.w[2] = r.w[3] = static_cast<uint64_t>(static_cast<int64_t>(r.w[1]) >> 63);
  return r;
}

}  // namespace

#ifdef __CUDACC__

namespace {

template <int OP>
__global__ void __launch_bounds__(256)
decimal128_kernel(const int32_t* __restrict__ a, long long sa,
                  const int32_t* __restrict__ b, long long sb, long long n,
                  int a_c, int b_c, int out_c, int cast_interim,
                  void* __restrict__ out, bool* __restrict__ overflow,
                  int* __restrict__ err) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 va = *reinterpret_cast<const uint4*>(a + 4 * sa * i);
  const uint4 vb = *reinterpret_cast<const uint4*>(b + 4 * sb * i);
  U256 res;
  bool over;
  row_op<OP>(from_limbs(va.x, va.y, va.z, va.w),
             from_limbs(vb.x, vb.y, vb.z, vb.w), a_c, b_c, out_c,
             cast_interim, &res, &over, err);
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

// Never launched: their SASS gives the fewest instructions of one per-row
// reciprocal and one 2-by-1 digit step, less those of h2_probe_base, for
// the operations bound that chip_smoke.py and chip_h2.py count.
extern "C" __global__ void h2_probe_base(const uint64_t* in, uint64_t* out) {
  out[0] = in[0] ^ in[2];
  out[1] = in[1] ^ in[3];
}

extern "C" __global__ void h2_probe_reciprocal_2by1(const uint64_t* in,
                                                    uint64_t* out) {
  out[0] = reciprocal_2by1(in[0] ^ in[2]);
  out[1] = in[1] ^ in[3];
}

extern "C" __global__ void h2_probe_step_2by1(const uint64_t* in,
                                              uint64_t* out) {
  out[0] = div_2by1(in[0], in[1], in[2], in[3], out + 1);
}

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

#else  // the host build, for the tests

namespace {

template <int OP>
void host_rows(const int32_t* a, long long sa, const int32_t* b,
               long long sb, long long n, int a_c, int b_c, int out_c,
               int cast_interim, void* out, bool* overflow, int* err) {
  for (long long i = 0; i < n; ++i) {
    uint32_t x[4], y[4];
    memcpy(x, a + 4 * sa * i, 16);
    memcpy(y, b + 4 * sb * i, 16);
    U256 res;
    bool over;
    row_op<OP>(from_limbs(x[0], x[1], x[2], x[3]),
               from_limbs(y[0], y[1], y[2], y[3]), a_c, b_c, out_c,
               cast_interim, &res, &over, err);
    overflow[i] = over;
    if (OP == kIntDiv) {
      static_cast<int64_t*>(out)[i] = static_cast<int64_t>(res.w[0]);
    } else {
      memcpy(static_cast<int32_t*>(out) + 4 * i, res.w, 16);
    }
  }
}

}  // namespace

extern "C" {

// srjt_decimal128_op's arithmetic on the host, row by row (no stream)
int srjt_decimal128_op_host(int op, const int32_t* a, long long sa,
                            const int32_t* b, long long sb, long long n,
                            int a_c, int b_c, int out_c, int cast_interim,
                            void* out, bool* overflow, int* err) {
  switch (op) {
    case kAdd:
      host_rows<kAdd>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim, out,
                      overflow, err);
      return 0;
    case kSub:
      host_rows<kSub>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim, out,
                      overflow, err);
      return 0;
    case kMul:
      host_rows<kMul>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim, out,
                      overflow, err);
      return 0;
    case kDiv:
      host_rows<kDiv>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim, out,
                      overflow, err);
      return 0;
    case kIntDiv:
      host_rows<kIntDiv>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim,
                         out, overflow, err);
      return 0;
    case kRem:
      host_rows<kRem>(a, sa, b, sb, n, a_c, b_c, out_c, cast_interim, out,
                      overflow, err);
      return 0;
    default:
      return -1;
  }
}

// divmod_u of unsigned 256-bit n by d, rows of four little-endian words
void srjt_h2_divmod_host(const uint64_t* n, const uint64_t* d,
                         long long rows, uint64_t* q, uint64_t* r) {
  for (long long i = 0; i < rows; ++i) {
    U256 nn, dd, qq, rr;
    memcpy(nn.w, n + 4 * i, 32);
    memcpy(dd.w, d + 4 * i, 32);
    divmod_u(nn, dd, &qq, &rr);
    memcpy(q + 4 * i, qq.w, 32);
    memcpy(r + 4 * i, rr.w, 32);
  }
}

// the reciprocals of normalised (d1, d0) pairs: reciprocal_2by1(d1) and
// reciprocal_3by2 of the pair
void srjt_h2_reciprocals_host(const uint64_t* d, long long rows,
                              uint64_t* v2by1, uint64_t* v3by2) {
  for (long long i = 0; i < rows; ++i) {
    v2by1[i] = reciprocal_2by1(d[2 * i]);
    v3by2[i] = reciprocal_3by2(v2by1[i], d[2 * i], d[2 * i + 1]);
  }
}

// the branch counts since the last call (kNumCounts of them), then 0
int srjt_h2_take_counts(long long* out) {
  memcpy(out, h2_counts, sizeof(h2_counts));
  memset(h2_counts, 0, sizeof(h2_counts));
  return kNumCounts;
}

}  // extern "C"

#endif  // __CUDACC__
