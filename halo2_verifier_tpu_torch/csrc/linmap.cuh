// Exact linear maps over BN254 Fq and Fr with small integer coefficients:
// the arithmetic of the fused Fq12 multiply's three maps (fq12_mul in
// tower.cu).
//
// What it computes: sum_j c_j x_j mod N, canonical, for canonical x_j and
// small signed c_j: the function of pairing_jax.py's linear combine
// (:245) with `_reduce_mod_p`, so the result is the unique canonical residue that
// ops/pairing.py linear_combine_plain returns, bit for bit.
//
// Design: a multiply-accumulate per nonzero coefficient and ONE reduction
// per output, where a sum of |c| modular adds would run up to 252
// dependent adds per output (the Fq12 recombination map MC).
// - Column sums: x_j's eight 32-bit words times the signed c_j add into
//   eight signed 64-bit columns, no carry chain. Bound: with
//   sum_j |c_j| <= 256 per output (ops/pairing.py _map_bound refuses
//   wider maps; MA and MB have row sums of 8, MC at most 252) each column
//   stays below 256 * 2^32 = 2^40 in magnitude, and the sum's value lies
//   in (-256 N, 256 N).
// - One reduction: X = sum + 256 N is in [0, 512 N), so below 2^263; an
//   exact signed carry pass gives its nine words. The quotient estimate q = floor((X >> 224) / (N_7 + 1)),
//   N_7 N's top word (0x30644e72 for both moduli), never exceeds X / N and
//   falls short of it by less than 1 + 2^-18, so X - q N is in [0, 2N):
//   one pass of q N_j subtracted from the words, then one conditional
//   subtract (field.cuh cond_sub), gives the canonical residue.

#pragma once

#include <cstdint>

#include "field.cuh"

namespace h2v {

// 256 N as nine 32-bit words, Fq then Fr: the borrow-free offset.
static __constant__ uint32_t LIN_OFFSET[2][9] = {
    {0x7cfd4700u, 0x208c16d8u, 0x71ca8d3cu, 0x816a9168u, 0x81585d97u,
     0x5045b681u, 0x31a029b8u, 0x644e72e1u, 0x00000030u},
    {0x00000100u, 0xe1f593f0u, 0xb9709143u, 0x33e84879u, 0x81585d28u,
     0x5045b681u, 0x31a029b8u, 0x644e72e1u, 0x00000030u},
};
// N's top word plus one, the quotient estimate's divisor (both moduli).
constexpr uint64_t kLinTopPlus1 = 0x30644e73ull;

// d += c * x (|c| at most 256 over a map's row).
__device__ __forceinline__ void lin_mac(int64_t (&d)[8], int32_t c,
                                        const uint32_t* x) {
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] += (int64_t)c * x[j];
}

// The canonical residue of sum_j d[j] 2^(32 j), for signed columns whose
// value lies in (-256 N, 256 N) and each column below 2^40 in magnitude.
template <int F>
__device__ __forceinline__ Fe lin_reduce(const int64_t (&d)[8]) {
    uint32_t w[9];
    int64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int64_t v = d[j] + (int64_t)LIN_OFFSET[F][j] + carry;
        w[j] = (uint32_t)v;
        carry = v >> 32;  // arithmetic: the running value may be negative
    }
    w[8] = (uint32_t)(carry + LIN_OFFSET[F][8]);  // X >= 0: no borrow out
    const uint32_t q =
        (uint32_t)((((uint64_t)w[8] << 32) | w[7]) / kLinTopPlus1);
    Fe r;
    carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int64_t v =
            (int64_t)w[j] - (int64_t)((uint64_t)q * MOD[F][j]) + carry;
        r.w[j] = (uint32_t)v;
        carry = v >> 32;
    }
    // X - q N < 2N < 2^255: what is left above word 7 cancels to 0
    return cond_sub<F>(r);
}

}  // namespace h2v
