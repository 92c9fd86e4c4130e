// Radix-2^29 Montgomery arithmetic for BN254 Fq and Fr: the arithmetic of
// the one-warp exponentiation chains, the decomp pre-pass's square root
// (mont_mul.cu) and the Fermat inversion (tower.cu), and of the doubling
// (point_double.cu), where its products cost fewer instructions than the
// word products' carry chains.
//
// Why a second arithmetic beside field.cuh's: a chain of dependent
// products at a few lanes per warp is bound by one product's latency, and
// field.cuh's 32-bit-word CIOS product is one long carry chain (ptxas
// lowers each madc to an IMAD and an IADD3.X through a carry predicate):
// ~1,550-2,200 clocks per product in a chain. Here ~1,040:
// - Unsaturated radix-2^29 limbs (nine per element) with 64-bit column
//   accumulators: each word product is one IMAD.WIDE.U32 that adds into
//   its column (mad.wide.u32), no carry chain; nine products per column
//   and the reduction's nine stay below 2^63 (limbs below 2^29 + 2^7), so
//   columns never overflow. Every product of a row is independent of the
//   others, and the only serial chain is the reduction factor m of each
//   row (9 rows). Internal Montgomery radix R' = 2^261.
// - Lazy reduction: every value stays below 2N without a conditional
//   subtract (a, b < 2^256 gives ab/R' + N < 2N, as 4N < R'); the limbs
//   leave each product after two parallel carry passes, below 2^29 + 2^7,
//   not exactly normalized. One exact carry pass (normalize29) and one
//   conditional subtract (field.cuh cond_sub) at the end give the
//   canonical result.
// - A dedicated squaring: 45 word products for a^2 (cross terms doubled)
//   instead of 81.
// - A fixed window of W bits over a constant exponent, left to right
//   (pow_window29; ops/decomp.py pow_window runs the same schedule on the
//   plain bodies).
// Both moduli are below 2^254, so every bound above holds for either; F
// selects the modulus (0 = Fq, 1 = Fr) as in field.cuh.

#pragma once

#include <cstdint>

#include "field.cuh"

namespace h2v {

// value = sum_j l[j] * 2^(29 j)
struct E29 {
    uint32_t l[9];
};

constexpr uint32_t kMask29 = (1u << 29) - 1;

// The moduli in radix 2^29 and -N^-1 mod 2^29, Fq then Fr (checked
// against ops/constants.py by tests/test_torch_field.py).
static __constant__ uint32_t MOD29[2][9] = {
    {0x187cfd47u, 0x010460b6u, 0x1c72a34fu, 0x02d522d0u, 0x1585d978u,
     0x02db40c0u, 0x00a6e141u, 0x0e5c2634u, 0x0030644eu},
    {0x10000001u, 0x1f0fac9fu, 0x0e5c2450u, 0x07d090f3u, 0x1585d283u,
     0x02db40c0u, 0x00a6e141u, 0x0e5c2634u, 0x0030644eu},
};
static __constant__ uint32_t NINV29[2] = {0x04866389u, 0x0fffffffu};

__device__ __forceinline__ E29 from_const29(const uint32_t* c) {
    E29 r;
#pragma unroll
    for (int j = 0; j < 9; ++j) r.l[j] = c[j];
    return r;
}

// t = sum_k t[k] 2^(29 k) -> t * 2^-261 mod N, below 2N: nine rows of
// m = t[i] * (-N^-1) mod 2^29, t += m N 2^(29 i), carry t[i] / 2^29 up;
// then the columns t[9..16] in two parallel carry passes to limbs below
// 2^29 + 2^7 (the value is below 2N < 2^255, so limb 8 stays below 2^23).
template <int F>
__device__ __forceinline__ E29 redc29(uint64_t (&t)[17]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        uint32_t m = ((uint32_t)t[i] * NINV29[F]) & kMask29;
#pragma unroll
        for (int j = 0; j < 9; ++j) t[i + j] += (uint64_t)m * MOD29[F][j];
        t[i + 1] += t[i] >> 29;
    }
    uint64_t u[9];
    u[0] = t[9] & kMask29;
#pragma unroll
    for (int j = 1; j < 8; ++j)
        u[j] = (t[9 + j] & kMask29) + (t[8 + j] >> 29);
    u[8] = t[16] >> 29;
    E29 r;
    r.l[0] = (uint32_t)u[0];
#pragma unroll
    for (int j = 1; j < 8; ++j)
        r.l[j] = ((uint32_t)u[j] & kMask29) + (uint32_t)(u[j - 1] >> 29);
    r.l[8] = (uint32_t)(u[8] + (u[7] >> 29));
    return r;
}

template <int F>
__device__ __forceinline__ E29 mul29(const E29& a, const E29& b) {
    uint64_t t[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j < 9; ++j) t[i + j] += (uint64_t)a.l[i] * b.l[j];
    return redc29<F>(t);
}

template <int F>
__device__ __forceinline__ E29 sqr29(const E29& a) {
    uint64_t t[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        uint32_t a2 = a.l[i] << 1;
#pragma unroll
        for (int j = i + 1; j < 9; ++j) t[i + j] += (uint64_t)a2 * a.l[j];
        t[2 * i] += (uint64_t)a.l[i] * a.l[i];
    }
    return redc29<F>(t);
}

// (a b + c d) 2^-261 mod N: both products summed into one set of columns,
// then one redc29. With limbs below 2^29 in a, b and c and below 2^30 in
// d, a column holds at most 9 * 2^58 + 9 * 2^59 + the reduction's 9 * 2^58
// < 2^63.2, and the result is below (ab + cd) / 2^261 + N.
template <int F>
__device__ __forceinline__ E29 mul2_29(const E29& a, const E29& b,
                                       const E29& c, const E29& d) {
    uint64_t t[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j < 9; ++j) {
            t[i + j] += (uint64_t)a.l[i] * b.l[j];
            t[i + j] += (uint64_t)c.l[i] * d.l[j];
        }
    return redc29<F>(t);
}

// a * 2^-261 mod N (out of Montgomery form), at most N.
template <int F>
__device__ __forceinline__ E29 from_mont29(const E29& a) {
    uint64_t t[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) t[k] = k < 9 ? a.l[k] : 0;
    return redc29<F>(t);
}

// Exact limbs below 2^29 (limb 8 takes the rest), same value.
__device__ __forceinline__ E29 normalize29(const E29& a) {
    E29 r;
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint32_t v = a.l[j] + c;
        r.l[j] = v & kMask29;
        c = v >> 29;
    }
    r.l[8] = a.l[8] + c;
    return r;
}

// Exact limbs of x * 2^S for x < 2^256 (S <= 5, so the value stays below
// 2^261): limb j holds bits [29 j - S, 29 j - S + 29) of x.
template <int S = 0>
__device__ __forceinline__ E29 from_words(const Fe& x) {
    E29 r;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
        const int bit = 29 * j - S;
        uint32_t v;
        if (bit < 0) {
            v = x.w[0] << -bit;
        } else {
            const int k = bit >> 5, s = bit & 31;
            v = x.w[k] >> s;
            if (s > 3 && k + 1 < 8) v |= x.w[k + 1] << (32 - s);
        }
        r.l[j] = v & kMask29;
    }
    return r;
}

// Exact limbs of a * 2^K for exact limbs a (limb 8 takes the top bits).
template <int K>
__device__ __forceinline__ E29 shl29(const E29& a) {
    E29 r;
    r.l[0] = (a.l[0] << K) & kMask29;
#pragma unroll
    for (int j = 1; j < 8; ++j)
        r.l[j] = ((a.l[j] << K) & kMask29) | (a.l[j - 1] >> (29 - K));
    r.l[8] = (a.l[8] << K) | (a.l[7] >> (29 - K));
    return r;
}

// a / 2 mod N for limbs below 2^30: a + N if a is odd (its parity is limb
// 0's), then halved, each odd limb's half bit moved into the limb below.
// The value is (a + N) / 2 at most; limbs stay below 2^30.
template <int F>
__device__ __forceinline__ E29 half29(const E29& a) {
    const uint32_t odd = 0u - (a.l[0] & 1u);
    uint32_t u[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = a.l[j] + (MOD29[F][j] & odd);
    E29 r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.l[j] = (u[j] >> 1) + ((u[j + 1] & 1u) << 28);
    r.l[8] = u[8] >> 1;
    return r;
}

// a - q N for q = floor(a_8 / (N_8 + 1)) on the exact limbs of a < 2^258:
// q N <= q (N_8 + 1) 2^232 <= a, and a - q N < (N_8 + q + 1) 2^232 <=
// N + 2^237, so the result, in exact limbs, is below 2N. Both moduli have
// the top limb N_8 = 0x30644e, so q is a division by a constant.
template <int F>
__device__ __forceinline__ E29 reduce_top29(const E29& a) {
    constexpr uint32_t kTop29 = 0x0030644eu;
    const E29 e = normalize29(a);
    const uint32_t q = e.l[8] / (kTop29 + 1);
    E29 r;
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int64_t s =
            (int64_t)e.l[j] - (int64_t)((uint64_t)q * MOD29[F][j]) + c;
        r.l[j] = (uint32_t)s & kMask29;
        c = s >> 29;  // arithmetic: floor
    }
    r.l[8] = (uint32_t)((int64_t)e.l[8] - (int64_t)q * kTop29 + c);
    return r;
}

// Exact limbs of a value below 2^256 -> eight 32-bit words.
__device__ __forceinline__ Fe to_words(const E29& a) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int bit = 32 * k, j = bit / 29, s = bit % 29;
        uint32_t v = a.l[j] >> s;
        if (j + 1 < 9) v |= a.l[j + 1] << (29 - s);
        if (58 - s < 32 && j + 2 < 9) v |= a.l[j + 2] << (58 - s);
        r.w[k] = v;
    }
    return r;
}

// Digit k (bits [W k, W k + W)) of the exponent e (eight 32-bit words);
// the same for every lane.
template <int W>
__device__ __forceinline__ uint32_t exp_digit(const uint32_t (&e)[8],
                                              int k) {
    const int bit = W * k, word = bit >> 5, s = bit & 31;
    uint32_t v = e[word] >> s;
    if (s + W > 32 && word + 1 < 8) v |= e[word + 1] << (32 - s);
    return v & ((1u << W) - 1);
}

// r[l] <- r[l]^e for L independent lanes and the constant exponent e of
// kBits bits, by a fixed window of W bits, most significant first: the
// table base^1..base^(2^W - 1) (one squaring, 2^W - 3 products, kept in
// local memory), then per lower digit W squarings and a product unless
// the digit is 0 (ops/decomp.py pow_window, window_chain_counts). The
// lanes' products sit in one basic block, so their chains interleave.
template <int F, int W, int L, int kBits>
__device__ __forceinline__ void pow_window29(E29 (&r)[L],
                                             const uint32_t (&e)[8]) {
    constexpr int kDigits = (kBits + W - 1) / W;
    E29 tab[L][1 << W];  // tab[l][d] = base^d for d >= 1
#pragma unroll
    for (int l = 0; l < L; ++l) tab[l][1] = r[l];
    if constexpr (W > 1) {
#pragma unroll
        for (int l = 0; l < L; ++l) tab[l][2] = sqr29<F>(r[l]);
#pragma unroll 1
        for (int d = 3; d < (1 << W); ++d)
#pragma unroll
            for (int l = 0; l < L; ++l)
                tab[l][d] = mul29<F>(tab[l][d - 1], r[l]);
    }
    const uint32_t top = exp_digit<W>(e, kDigits - 1);
#pragma unroll
    for (int l = 0; l < L; ++l) r[l] = tab[l][top];
#pragma unroll 1
    for (int k = kDigits - 2; k >= 0; --k) {
#pragma unroll
        for (int s = 0; s < W; ++s)
#pragma unroll
            for (int l = 0; l < L; ++l) r[l] = sqr29<F>(r[l]);
        const uint32_t d = exp_digit<W>(e, k);
        if (d) {
#pragma unroll
            for (int l = 0; l < L; ++l) r[l] = mul29<F>(r[l], tab[l][d]);
        }
    }
}

}  // namespace h2v
