// BN254 Fq/Fr Montgomery arithmetic for Hopper kernels (sm_90a).
//
// Device functions shared by the Montgomery-multiply kernels (mont_mul.cu,
// mont_mul8.cu), the fused square-root kernel (mont_mul.cu) and the point
// kernels (point_add.cu, point_add8.cu, point_double.cu, through
// point.cuh). An element lives in registers as eight 32-bit words,
// little-endian; in device memory it is the reference's limbs-major layout,
// (16, W) int32 rows of 16-bit limbs, limb k of lane i at base[k * W + i],
// so the 32 lanes of a warp read 32 neighbouring words of each limb row.
//
// On canonical inputs (below N) every function returns the canonical
// result, as the reference's bodies do (halo2_verifier_tpu/ops/lmfield.py),
// so the plain torch bodies (ops/field.py) equal these bit for bit; every
// operand on the main path is canonical. Like the reference, products and
// sums are kept mod 2^256 and reduced once.

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

__device__ __forceinline__ Fe load_fe(const int32_t* __restrict__ base,
                                      long long width, long long lane) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint32_t lo = (uint32_t)base[(2 * j) * width + lane];
        uint32_t hi = (uint32_t)base[(2 * j + 1) * width + lane];
        r.w[j] = lo | (hi << 16);
    }
    return r;
}

__device__ __forceinline__ void store_fe(int32_t* __restrict__ base,
                                         long long width, long long lane,
                                         const Fe& a) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        base[(2 * j) * width + lane] = (int32_t)(a.w[j] & 0xFFFFu);
        base[(2 * j + 1) * width + lane] = (int32_t)(a.w[j] >> 16);
    }
}

// The second limb format (halo2_verifier_tpu/ops/lmfield8.py): (32, W)
// float32 rows of 8-bit limbs, limb k of lane i at base[k * W + i], each an
// integer in [0, 255]. Word j holds limbs 4j..4j+3. Montgomery R is 2^256
// in both formats, so the words, and all arithmetic on them, are the same.
__device__ __forceinline__ Fe load_fe8(const float* __restrict__ base,
                                       long long width, long long lane) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint32_t w = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            w |= (uint32_t)base[(4 * j + k) * width + lane] << (8 * k);
        r.w[j] = w;
    }
    return r;
}

__device__ __forceinline__ void store_fe8(float* __restrict__ base,
                                          long long width, long long lane,
                                          const Fe& a) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            base[(4 * j + k) * width + lane] =
                (float)((a.w[j] >> (8 * k)) & 0xFFu);
    }
}

// The two formats as types, for kernels written once over both.
struct Limbs16 {
    using T = int32_t;
    static __device__ __forceinline__ Fe load(const T* __restrict__ base,
                                              long long width,
                                              long long lane) {
        return load_fe(base, width, lane);
    }
    static __device__ __forceinline__ void store(T* __restrict__ base,
                                                 long long width,
                                                 long long lane,
                                                 const Fe& a) {
        store_fe(base, width, lane, a);
    }
};

struct Limbs8 {
    using T = float;
    static __device__ __forceinline__ Fe load(const T* __restrict__ base,
                                              long long width,
                                              long long lane) {
        return load_fe8(base, width, lane);
    }
    static __device__ __forceinline__ void store(T* __restrict__ base,
                                                 long long width,
                                                 long long lane,
                                                 const Fe& a) {
        store_fe8(base, width, lane, a);
    }
};

// x - N if x >= N else x (lmfield.cond_sub_n)
template <int F>
__device__ __forceinline__ Fe cond_sub(const Fe& x) {
    Fe d;
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint64_t s = (uint64_t)x.w[j] - MOD[F][j] - borrow;
        d.w[j] = (uint32_t)s;
        borrow = (uint32_t)(s >> 63);
    }
    return borrow ? x : d;
}

// (a + b) mod 2^256, then one conditional subtract (lmfield.add_body)
template <int F>
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
    Fe s;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c += (uint64_t)a.w[j] + b.w[j];
        s.w[j] = (uint32_t)c;
        c >>= 32;
    }
    return cond_sub<F>(s);
}

// a - b, plus N on borrow, mod 2^256 (lmfield.sub_body)
template <int F>
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
    Fe d;
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
        d.w[j] = (uint32_t)s;
        borrow = (uint32_t)(s >> 63);
    }
    if (borrow) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (uint64_t)d.w[j] + MOD[F][j];
            d.w[j] = (uint32_t)c;
            c >>= 32;
        }
    }
    return d;
}

// Montgomery product a * b * 2^-256 mod N by word-serial CIOS on eight
// 32-bit words: 64 word products for a*b and 64 + 8 for the reduction,
// against 256 + 136 + 256 limb products (and their carry folds) in the
// reference's 16-bit-limb convolutions. The result (ab + mN) / 2^256 with
// m in [0, 2^256) is below 2^256 + N; like the reference it is kept mod
// 2^256 and reduced once.
template <int F>
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
    uint32_t t[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[8] + c;
        t[8] = (uint32_t)s;
        t[9] = (uint32_t)(s >> 32);
        uint32_t m = t[0] * N0INV[F];
        s = (uint64_t)m * MOD[F][0] + t[0];
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            s = (uint64_t)m * MOD[F][j] + t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[8] + c;
        t[7] = (uint32_t)s;
        t[8] = t[9] + (uint32_t)(s >> 32);
    }
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = t[j];
    return cond_sub<F>(r);
}

}  // namespace h2v
