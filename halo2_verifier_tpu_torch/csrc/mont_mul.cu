// K1: Montgomery multiply, and the decomp pre-pass's square root.
//
// Replaces halo2_verifier_tpu/ops/lmfield.py `_mont_mul_pallas` (body
// `_mm_kernel`), the TPU kernel that `lmfield.mont_mul` dispatches to, and
// the square root of ops/decomp_jax.py `_y_principal`, which runs K1 and
// the plain body under lax.scan.
//
// Montgomery multiply, design: one thread per lane (field element). The
// TPU kernel keeps a (16, 1024) block in VMEM and runs three 16x16-limb
// convolutions as whole-tile vector ops; here each thread packs its 16
// limbs into eight 32-bit words in registers and runs a word-serial CIOS
// product (field.cuh), so nothing but the operands and the result touches
// memory. Bound on this card: one product moves 3 x 64 B per lane (2 in,
// 1 out) and needs 264 multiply-adds: under the card's balance point, so
// bound by bytes. Its one verifier path is the u16 scan's conversion
// (532,480 lanes); the forest converts inside csrc/frontier.cu.
//
// Square root, what it computes: y = (x^3 + 3)^((q+1)/4), canonical, out
// of Montgomery form, for canonical x; bit-equal to ops/decomp.py
// y_principal_plain (the result is a canonical residue, unique, so the
// internal representation below is free).
//
// Square root, what bounds it: the main path runs it on 15 points x 1,024
// proofs = 15,360 lanes, 480 warps: fewer than the card's 528 warp
// schedulers. With blocks of at most 128 threads each scheduler holds at
// most one warp, and the launch takes as long as one warp takes for its
// lanes' chain of 322 dependent products (the same time at 32 lanes as
// at 15,360). The 32-bit-word CIOS product of field.cuh is one long carry
// chain (ptxas lowers each madc to an IMAD and an IADD3.X through a carry
// predicate): ~2,200 clocks per product in that chain. The design below
// takes ~1,040, and two lanes per thread (SqrtShape::kLanes = 2) take
// twice as long per launch: the one warp's multiply-add issue binds now,
// not latency (PERF.md).
//
// Square root, design:
// - Unsaturated radix-2^29 limbs (nine per element) with 64-bit column
//   accumulators: each word product is one IMAD.WIDE.U32 that adds into
//   its column (mad.wide.u32), no carry chain; nine products per column
//   and the reduction's nine stay below 2^63 (limbs below 2^29 + 2^7), so
//   columns never overflow. Every product of a row is independent of the
//   others, and the only serial chain is the reduction factor m of each
//   row (9 rows). Internal Montgomery radix R' = 2^261.
// - Lazy reduction: every value stays below 2q without a conditional
//   subtract (a, b < 2^256 gives ab/R' + q < 2q, as 4q < R'); the limbs
//   leave each product after two parallel carry passes, below 2^29 + 2^7,
//   not exactly normalized. One exact carry pass and one conditional
//   subtract at the end give the canonical root.
// - A dedicated squaring: 45 word products for a^2 (cross terms doubled)
//   instead of 81.
// - A fixed window of SqrtShape::kWindow bits, left to right, over the
//   constant exponent: with 4 bits, 249 squarings and 69 multiplies
//   (13 for the table base^1..base^15, kept in local memory) instead of
//   251 and 109; 322 products per lane with the three of x^3 + 3 and the
//   one out of Montgomery form (ops/decomp.py sqrt_chain_counts).
// - Blocks of SqrtShape::kThreads = 64 threads spread the 480 warps over
//   all 132 SMs (256-thread blocks fill 60 SMs with 2 warps per
//   scheduler: 1.56x the time), one lane per thread.
// The shape was chosen on the card by sweep_kernels.py sqrt; the numbers
// are in PERF.md.

#include <cuda_runtime.h>

#include "field.cuh"

// (q + 1) / 4 as 32-bit words.
static __constant__ uint32_t SQRT_EXP[8] = {
    0xb61f3f52u, 0x4f082305u, 0x5a1c72a3u, 0x65e05aa4u,
    0xa0605617u, 0x6e14116du, 0xb84c680au, 0x0c19139cu};

// Fq in radix 2^29 (nine limbs), and R' = 2^261 constants: R'^2 mod q and
// 3R' mod q (the curve's b in this Montgomery form).
static __constant__ uint32_t Q29[9] = {
    0x187cfd47u, 0x010460b6u, 0x1c72a34fu, 0x02d522d0u, 0x1585d978u,
    0x02db40c0u, 0x00a6e141u, 0x0e5c2634u, 0x0030644eu};
static __constant__ uint32_t R2_29[9] = {
    0x059bac10u, 0x0d1503a3u, 0x018016b8u, 0x10ab0ca8u, 0x02632639u,
    0x02c0169fu, 0x169bfd53u, 0x11869d4cu, 0x002a11a6u};
static __constant__ uint32_t B3_29[9] = {
    0x00766463u, 0x1c54760au, 0x08f6927au, 0x03e40c4du, 0x1fea4f2bu,
    0x17c6c26au, 0x157fe417u, 0x0f8056f9u, 0x002958a2u};

namespace {

using h2v::Fe;
using h2v::Limbs16;

constexpr int kThreads = 256;   // the Montgomery multiply's blocks
constexpr int kSqrtBits = 252;  // bit length of (q + 1) / 4

// The square root's launch shape, exponent window and lanes per thread.
struct SqrtShape {
    static constexpr int kThreads = 64;
    static constexpr int kWindow = 4;
    static constexpr int kLanes = 1;
};

constexpr uint32_t kMask29 = (1u << 29) - 1;
constexpr uint32_t kQInv29 = 0x04866389u;  // -q^-1 mod 2^29

// value = sum_j l[j] * 2^(29 j)
struct E29 {
    uint32_t l[9];
};

__device__ __forceinline__ E29 from_const29(const uint32_t* c) {
    E29 r;
#pragma unroll
    for (int j = 0; j < 9; ++j) r.l[j] = c[j];
    return r;
}

// t = sum_k t[k] 2^(29 k) -> t * 2^-261 mod q, below 2q: nine rows of
// m = t[i] * (-q^-1) mod 2^29, t += m q 2^(29 i), carry t[i] / 2^29 up;
// then the columns t[9..16] in two parallel carry passes to limbs below
// 2^29 + 2^7 (the value is below 2q < 2^255, so limb 8 stays below 2^23).
__device__ __forceinline__ E29 redc29(uint64_t (&t)[17]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        uint32_t m = ((uint32_t)t[i] * kQInv29) & kMask29;
#pragma unroll
        for (int j = 0; j < 9; ++j) t[i + j] += (uint64_t)m * Q29[j];
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

__device__ __forceinline__ E29 mul29(const E29& a, const E29& b) {
    uint64_t t[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j < 9; ++j) t[i + j] += (uint64_t)a.l[i] * b.l[j];
    return redc29(t);
}

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
    return redc29(t);
}

// a * 2^-261 mod q (out of Montgomery form), at most q.
__device__ __forceinline__ E29 from_mont29(const E29& a) {
    uint64_t t[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) t[k] = k < 9 ? a.l[k] : 0;
    return redc29(t);
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

__device__ __forceinline__ E29 from_words(const Fe& x) {
    E29 r;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
        const int bit = 29 * j, k = bit >> 5, s = bit & 31;
        uint32_t v = x.w[k] >> s;
        if (s > 3 && k + 1 < 8) v |= x.w[k + 1] << (32 - s);
        r.l[j] = v & kMask29;
    }
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

// Digit k (bits [W k, W k + W)) of (q + 1) / 4; the same for every lane.
template <int W>
__device__ __forceinline__ uint32_t exp_digit(int k) {
    const int bit = W * k, word = bit >> 5, s = bit & 31;
    uint32_t v = SQRT_EXP[word] >> s;
    if (s + W > 32 && word + 1 < 8) v |= SQRT_EXP[word + 1] << (32 - s);
    return v & ((1u << W) - 1);
}

// r[l] <- r[l]^((q+1)/4) for L independent lanes, by a fixed window of W
// bits, most significant first (ops/decomp.py pow_window mirrors it on
// the plain bodies); the lanes' products sit in one basic block, so their
// chains interleave.
template <int W, int L>
__device__ __forceinline__ void pow_sqrt_exp(E29 (&r)[L]) {
    constexpr int kDigits = (kSqrtBits + W - 1) / W;
    E29 tab[L][1 << W];  // tab[l][d] = base^d for d >= 1
#pragma unroll
    for (int l = 0; l < L; ++l) tab[l][1] = r[l];
    if constexpr (W > 1) {
#pragma unroll
        for (int l = 0; l < L; ++l) tab[l][2] = sqr29(r[l]);
#pragma unroll 1
        for (int d = 3; d < (1 << W); ++d)
#pragma unroll
            for (int l = 0; l < L; ++l) tab[l][d] = mul29(tab[l][d - 1], r[l]);
    }
    const uint32_t top = exp_digit<W>(kDigits - 1);
#pragma unroll
    for (int l = 0; l < L; ++l) r[l] = tab[l][top];
#pragma unroll 1
    for (int k = kDigits - 2; k >= 0; --k) {
#pragma unroll
        for (int s = 0; s < W; ++s)
#pragma unroll
            for (int l = 0; l < L; ++l) r[l] = sqr29(r[l]);
        const uint32_t d = exp_digit<W>(k);
        if (d) {
#pragma unroll
            for (int l = 0; l < L; ++l) r[l] = mul29(r[l], tab[l][d]);
        }
    }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, uint32_t width) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    Fe x = Limbs16::load(a + i, width);
    Fe y = Limbs16::load(b + i, width);
    Limbs16::store(out + i, width, h2v::mont_mul<F>(x, y));
}

// Thread t runs lanes t, t + n, ..., t + (L - 1) n of the width, n
// threads in all; a lane past the end recomputes the last one and is not
// stored.
template <int W, int L>
__global__ void __launch_bounds__(SqrtShape::kThreads)
sqrt_principal_kernel(const int32_t* __restrict__ xs,
                      int32_t* __restrict__ ys, uint32_t width, uint32_t n) {
    uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    E29 r[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
        uint32_t i = min(t + l * n, width - 1);
        E29 x = from_words(Limbs16::load(xs + i, width));
        E29 xm = mul29(x, from_const29(R2_29));
        E29 x3 = mul29(sqr29(xm), xm);
#pragma unroll
        for (int j = 0; j < 9; ++j) x3.l[j] += B3_29[j];
        r[l] = normalize29(x3);
    }
    pow_sqrt_exp<W, L>(r);
#pragma unroll
    for (int l = 0; l < L; ++l) {
        uint32_t i = t + l * n;
        // at most q: exact limbs, words, one conditional subtract
        if (i < width)
            Limbs16::store(ys + i, width, h2v::cond_sub<0>(to_words(
                normalize29(from_mont29(r[l])))));
    }
}

}  // namespace

extern "C" int h2v_mont_mul(const int32_t* a, const int32_t* b,
                            int32_t* out, long long width, int field,
                            void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned int blocks = (unsigned int)((width + kThreads - 1) / kThreads);
    if (field == 0)
        mont_mul_kernel<0><<<blocks, kThreads, 0, s>>>(a, b, out,
                                                       (uint32_t)width);
    else
        mont_mul_kernel<1><<<blocks, kThreads, 0, s>>>(a, b, out,
                                                       (uint32_t)width);
    return (int)cudaGetLastError();
}

extern "C" int h2v_sqrt_principal(const int32_t* xs, int32_t* ys,
                                  long long width, void* stream) {
    constexpr int T = SqrtShape::kThreads, L = SqrtShape::kLanes;
    long long n = (width + L - 1) / L;
    sqrt_principal_kernel<SqrtShape::kWindow, L>
        <<<(unsigned int)((n + T - 1) / T), T, 0, (cudaStream_t)stream>>>(
            xs, ys, (uint32_t)width, (uint32_t)n);
    return (int)cudaGetLastError();
}
