// BN254 Fq/Fr Montgomery arithmetic for Hopper kernels (sm_90a).
//
// Device functions shared by the Montgomery-multiply kernels (mont_mul.cu,
// mont_mul8.cu), the fused square-root kernel (mont_mul.cu) and the point
// kernels (point_add.cu, point_add8.cu, point_double.cu, through
// point.cuh). An element lives in registers as eight 32-bit words,
// little-endian; in device memory it is the reference's limbs-major layout,
// limb k of lane i at base[k * W + i], so the 32 lanes of a warp read 32
// neighbouring words of each limb row.
//
// On canonical inputs (below N) every function returns the canonical
// result, as the reference's bodies do (halo2_verifier_tpu/ops/lmfield.py),
// so the plain torch bodies (ops/field.py, ops/field8.py) equal these bit
// for bit; every operand on the main path is canonical. Like the
// reference, products and sums are kept mod 2^256 and reduced once: both
// moduli are below 2^254, so no intermediate below reaches 2^256 and the
// one conditional subtract at the end of each function lands on the
// canonical residue, which is unique.
//
// Design: every carry chain is written in PTX (add.cc/addc, sub.cc/subc,
// mad.lo.cc/madc.lo.cc/madc.hi.cc on 32-bit words), one chain per asm
// statement, because the carry flag is not guaranteed to survive between
// two asm statements. No uint64_t, no branch: the conditional subtracts
// select with selp. Addressing is 32-bit: a function gets the lane's own
// pointer and the row stride, and row k sits k * W elements further; the
// wrappers (ops/kernels.py) refuse any tensor of 2^31 elements or more.
//
// Bound (chip_smoke.py's model, by the SM pipe that runs each operation):
// a Montgomery product needs 264 integer multiply-adds on the FMA pipe
// (128 word products of 2 each, 8 reduction factors) and 16 ALU
// operations (the conditional subtract); the chains below issue 296 in
// PTX (16 more adds to carry each row into its ninth word). A modular add
// or subtract is 24 ALU operations in the model, 26 here. Measured on
// NVIDIA H100 80GB HBM3 at 700.00 W: see csrc/point_add.cu.

#pragma once

#include <cstdint>

namespace h2v {

struct Fe {
    uint32_t w[8];
};

// Moduli (0 = Fq, 1 = Fr) as 32-bit words, and -N^{-1} mod 2^32. The
// values are checked against ops/constants.py by tests/test_torch_field.py.
__constant__ uint32_t MOD[2][8] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
};
__constant__ uint32_t N0INV[2] = {0xe4866389u, 0xefffffffu};

// The 16-bit-limb format: (16, W) int32 rows, word j = limbs 2j, 2j + 1.
// p points at the lane's limb 0; w is the row stride in elements.
struct Limbs16 {
    using T = int32_t;
    static __device__ __forceinline__ Fe load(const T* __restrict__ p,
                                              uint32_t w) {
        Fe r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            r.w[j] = __byte_perm((uint32_t)p[(2 * j) * w],
                                 (uint32_t)p[(2 * j + 1) * w], 0x5410);
        return r;
    }
    static __device__ __forceinline__ void store(T* __restrict__ p,
                                                 uint32_t w, const Fe& a) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            p[(2 * j) * w] = (int32_t)(a.w[j] & 0xFFFFu);
            p[(2 * j + 1) * w] = (int32_t)(a.w[j] >> 16);
        }
    }
};

// The second limb format (halo2_verifier_tpu/ops/lmfield8.py): (32, W)
// float32 rows of 8-bit limbs, each an integer in [0, 255]; word j holds
// limbs 4j..4j+3. Montgomery R is 2^256 in both formats, so the words, and
// all arithmetic on them, are the same.
//
// The format is converted on the FP32 pipe with exact float identities,
// never with F2I/I2F (a quarter of the integer rate): every value below is
// an integer under 2^24, exact in float32, and the float 2^23 + x (x an
// integer in [0, 2^23)) has the bits 0x4B000000 | x.
// - load: fmaf(l1, 256, l0 + 2^23) = 2^23 + l0 + 256 l1, whose low 16 bits
//   are l0 + 256 l1; one byte_perm joins two such halves into a word;
// - store: byte_perm(w, 0x4B000000, 0x765k) is the bits of 2^23 + byte k
//   of w; subtracting 2^23 leaves the byte as an exact float.
// tests/test_torch_field8.py checks both identities exhaustively.
struct Limbs8 {
    using T = float;
    static __device__ __forceinline__ uint32_t half(float l0, float l1) {
        return __float_as_uint(fmaf(l1, 256.f, l0 + 8388608.f));
    }
    static __device__ __forceinline__ Fe load(const T* __restrict__ p,
                                              uint32_t w) {
        Fe r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            r.w[j] = __byte_perm(half(p[(4 * j) * w], p[(4 * j + 1) * w]),
                                 half(p[(4 * j + 2) * w],
                                      p[(4 * j + 3) * w]),
                                 0x5410);
        return r;
    }
    static __device__ __forceinline__ void store(T* __restrict__ p,
                                                 uint32_t w, const Fe& a) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                p[(4 * j + k) * w] =
                    __uint_as_float(__byte_perm(a.w[j], 0x4B000000u,
                                                0x7650u | k)) -
                    8388608.f;
        }
    }
};

// x - N if x >= N else x (lmfield.cond_sub_n), for x < 2^256: one subtract
// chain, its borrow as a predicate, eight selects.
template <int F>
__device__ __forceinline__ Fe cond_sub(const Fe& x) {
    const uint32_t* n = MOD[F];
    Fe r;
    asm("{\n\t"
        ".reg .u32 dd<8>;\n\t"
        ".reg .u32 bb;\n\t"
        ".reg .pred plt;\n\t"
        "sub.cc.u32  dd0, %8, %16;\n\t"
        "subc.cc.u32 dd1, %9, %17;\n\t"
        "subc.cc.u32 dd2, %10, %18;\n\t"
        "subc.cc.u32 dd3, %11, %19;\n\t"
        "subc.cc.u32 dd4, %12, %20;\n\t"
        "subc.cc.u32 dd5, %13, %21;\n\t"
        "subc.cc.u32 dd6, %14, %22;\n\t"
        "subc.cc.u32 dd7, %15, %23;\n\t"
        "subc.u32    bb, 0, 0;\n\t"
        "setp.ne.u32 plt, bb, 0;\n\t"
        "selp.b32 %0, %8, dd0, plt;\n\t"
        "selp.b32 %1, %9, dd1, plt;\n\t"
        "selp.b32 %2, %10, dd2, plt;\n\t"
        "selp.b32 %3, %11, dd3, plt;\n\t"
        "selp.b32 %4, %12, dd4, plt;\n\t"
        "selp.b32 %5, %13, dd5, plt;\n\t"
        "selp.b32 %6, %14, dd6, plt;\n\t"
        "selp.b32 %7, %15, dd7, plt;\n\t"
        "}"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
          "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7])
        : "r"(x.w[0]), "r"(x.w[1]), "r"(x.w[2]), "r"(x.w[3]), "r"(x.w[4]),
          "r"(x.w[5]), "r"(x.w[6]), "r"(x.w[7]), "r"(n[0]), "r"(n[1]),
          "r"(n[2]), "r"(n[3]), "r"(n[4]), "r"(n[5]), "r"(n[6]), "r"(n[7]));
    return r;
}

// (a + b) mod 2^256, then one conditional subtract (lmfield.add_body). For
// canonical a, b the sum is below 2N < 2^255: the chain never carries out.
template <int F>
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
    Fe s;
    asm("add.cc.u32  %0, %8, %16;\n\t"
        "addc.cc.u32 %1, %9, %17;\n\t"
        "addc.cc.u32 %2, %10, %18;\n\t"
        "addc.cc.u32 %3, %11, %19;\n\t"
        "addc.cc.u32 %4, %12, %20;\n\t"
        "addc.cc.u32 %5, %13, %21;\n\t"
        "addc.cc.u32 %6, %14, %22;\n\t"
        "addc.u32    %7, %15, %23;"
        : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]),
          "=r"(s.w[4]), "=r"(s.w[5]), "=r"(s.w[6]), "=r"(s.w[7])
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
          "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
          "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
          "r"(b.w[7]));
    return cond_sub<F>(s);
}

// a - b, plus N on borrow, mod 2^256 (lmfield.sub_body): the subtract
// chain, its borrow, then d + N in a second chain and a select.
template <int F>
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
    const uint32_t* n = MOD[F];
    Fe d, r;
    uint32_t bw;
    asm("sub.cc.u32  %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32    %8, 0, 0;"
        : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
          "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]), "=r"(bw)
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
          "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
          "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
          "r"(b.w[7]));
    asm("{\n\t"
        ".reg .u32 ee<8>;\n\t"
        ".reg .pred pbr;\n\t"
        "add.cc.u32  ee0, %8, %17;\n\t"
        "addc.cc.u32 ee1, %9, %18;\n\t"
        "addc.cc.u32 ee2, %10, %19;\n\t"
        "addc.cc.u32 ee3, %11, %20;\n\t"
        "addc.cc.u32 ee4, %12, %21;\n\t"
        "addc.cc.u32 ee5, %13, %22;\n\t"
        "addc.cc.u32 ee6, %14, %23;\n\t"
        "addc.u32    ee7, %15, %24;\n\t"
        "setp.ne.u32 pbr, %16, 0;\n\t"
        "selp.b32 %0, ee0, %8, pbr;\n\t"
        "selp.b32 %1, ee1, %9, pbr;\n\t"
        "selp.b32 %2, ee2, %10, pbr;\n\t"
        "selp.b32 %3, ee3, %11, pbr;\n\t"
        "selp.b32 %4, ee4, %12, pbr;\n\t"
        "selp.b32 %5, ee5, %13, pbr;\n\t"
        "selp.b32 %6, ee6, %14, pbr;\n\t"
        "selp.b32 %7, ee7, %15, pbr;\n\t"
        "}"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
          "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7])
        : "r"(d.w[0]), "r"(d.w[1]), "r"(d.w[2]), "r"(d.w[3]), "r"(d.w[4]),
          "r"(d.w[5]), "r"(d.w[6]), "r"(d.w[7]), "r"(bw), "r"(n[0]),
          "r"(n[1]), "r"(n[2]), "r"(n[3]), "r"(n[4]), "r"(n[5]), "r"(n[6]),
          "r"(n[7]));
    return r;
}

// t[0..8] += a * b for one word b: the low halves of the eight word
// products go into t[0..7] in one carry chain, which ends in t[8]; the high
// halves into t[1..8] in a second. The caller keeps the sum below 2^288,
// so neither chain carries out of t[8].
__device__ __forceinline__ void mad_row(uint32_t (&t)[9], const uint32_t* a,
                                        uint32_t b) {
    asm("mad.lo.cc.u32  %0, %9, %17, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
        "addc.u32       %8, %8, 0;\n\t"
        "mad.hi.cc.u32  %1, %9, %17, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
        "madc.hi.u32    %8, %16, %17, %8;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(a[6]), "r"(a[7]), "r"(b));
}

// Montgomery product a * b * 2^-256 mod N by word-serial CIOS on eight
// 32-bit words: 64 word products for a*b and 64 + 8 for the reduction,
// against 256 + 136 + 256 limb products (and their carry folds) in the
// reference's 16-bit-limb convolutions.
//
// Why the result is the canonical value: with t < 2N at the top of a row,
// t + a*b_i + m*N < 2N + 2^33 N - 2N = 2^33 N < 2^287 fits the nine words
// of t (N < 2^254), its low word is 0 by the choice of m, and the shift
// leaves (t + a*b_i + m*N) / 2^32 < 2N. So after eight rows t =
// a*b*2^-256 mod N plus 0 or N, below 2^255, and one conditional subtract
// gives the canonical residue, the one the reference's
// mod-2^256-then-reduce-once bodies return (including on the FOLD_EDGE
// operands of tests/test_torch_field.py, where the reference's m stands
// for m + 2^256).
template <int F>
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
    uint32_t t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        mad_row(t, a.w, b.w[i]);
        mad_row(t, MOD[F], t[0] * N0INV[F]);
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
        t[8] = 0;
    }
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = t[j];
    return cond_sub<F>(r);
}

}  // namespace h2v
