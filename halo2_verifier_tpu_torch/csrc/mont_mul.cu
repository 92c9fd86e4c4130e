// K1: Montgomery multiply, and the decomp pre-pass fused around it.
//
// Replaces halo2_verifier_tpu/ops/lmfield.py `_mont_mul_pallas` (body
// `_mm_kernel`), the TPU kernel that `lmfield.mont_mul` dispatches to, and
// the square root of ops/decomp_jax.py `_y_principal`, which runs K1 and
// the plain body under lax.scan.
//
// Design: one thread per lane (field element). The TPU kernel keeps a
// (16, 1024) block in VMEM and runs three 16x16-limb convolutions as
// whole-tile vector ops; here each thread packs its 16 limbs into eight
// 32-bit words in registers and runs a word-serial CIOS product
// (field.cuh), so nothing but the operands and the result touches memory.
//
// Bound on this card: one product moves 3 x 64 B per lane (2 in, 1 out)
// and needs at least 264 32-bit integer multiply-adds with fused carry
// chains (PTX mad.lo.cc/madc.hi.cc: 2 per word product, 128 word
// products; 8 for the reduction factors), which run on the FMA pipe, and
// 48 ALU operations (the final subtract, the limb packing): ~1.4
// multiply-adds per byte, under the card's balance point of ~5 (132 SMs x
// 64 multiply-adds per clock x 1.98 GHz = 16.7 T/s over 3.35 TB/s), so
// alone K1 is bound by bytes, and at the main path's width (17,408 lanes
// for point conversion) by its launch. Inside the point add and the
// square root, where operands stay in registers, the same product is bound
// by integer throughput; the 32-bit-word CIOS is the answer there: it
// needs several times fewer operations than the 16-bit-limb convolutions
// the TPU's 32-bit lanes needed. The carry chains are PTX (field.cuh);
// ptxas turns each madc into an IMAD and an IADD3.X on sm_90, so a
// product issues about 580 SASS instructions, twice the count above. The
// square root is one serial chain of products per lane at 15,360 lanes
// (60 blocks of 256 threads): bound by that chain's latency, not by issue.
//
// The fused square root runs the whole exponentiation per lane in
// registers: x -> Montgomery, x^3 + 3, then (x^3+3)^((q+1)/4) by the
// reference's LSB-first square-and-multiply over the exponent's 252 bits
// (the reference runs 256; its last 4 bits are zero and only square a base
// it discards, and a zero bit skips the product the reference computes and
// discards), then out of Montgomery form: 364 products per lane in one
// launch instead of 512 K1 launches.

#include <cuda_runtime.h>

#include "field.cuh"

// Fq constants: R^2 mod q, R mod q (one), 3R mod q (the curve's b in
// Montgomery form), and (q + 1) / 4, as 32-bit words.
static __constant__ uint32_t R2_FQ[8] = {
    0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
    0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u};
static __constant__ uint32_t ONE_FQ[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
static __constant__ uint32_t B_FQ[8] = {
    0x50ad28d7u, 0x7a17caa9u, 0xe15521b9u, 0x1f6ac17au,
    0x696bd284u, 0x334bea4eu, 0xce179d8eu, 0x2a1f6744u};
static __constant__ uint32_t SQRT_EXP[8] = {
    0xb61f3f52u, 0x4f082305u, 0x5a1c72a3u, 0x65e05aa4u,
    0xa0605617u, 0x6e14116du, 0xb84c680au, 0x0c19139cu};

namespace {

using h2v::Fe;
using h2v::Limbs16;

constexpr int kThreads = 256;
constexpr int kSqrtBits = 252;  // bit length of (q + 1) / 4

__device__ __forceinline__ Fe from_const(const uint32_t* c) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = c[j];
    return r;
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

__global__ void __launch_bounds__(kThreads)
sqrt_principal_kernel(const int32_t* __restrict__ xs,
                      int32_t* __restrict__ ys, uint32_t width) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    Fe x = Limbs16::load(xs + i, width);
    Fe xm = h2v::mont_mul<0>(x, from_const(R2_FQ));
    Fe x3 = h2v::mont_mul<0>(h2v::mont_mul<0>(xm, xm), xm);
    Fe base = h2v::add<0>(x3, from_const(B_FQ));
    Fe result = from_const(ONE_FQ);
    for (int k = 0; k < kSqrtBits; ++k) {
        if ((SQRT_EXP[k >> 5] >> (k & 31)) & 1u)
            result = h2v::mont_mul<0>(result, base);
        if (k < kSqrtBits - 1) base = h2v::mont_mul<0>(base, base);
    }
    Fe one_plain = {{1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
    Limbs16::store(ys + i, width, h2v::mont_mul<0>(result, one_plain));
}

unsigned int blocks_for(long long width) {
    return (unsigned int)((width + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int h2v_mont_mul(const int32_t* a, const int32_t* b,
                            int32_t* out, long long width, int field,
                            void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
        mont_mul_kernel<0><<<blocks_for(width), kThreads, 0, s>>>(
            a, b, out, (uint32_t)width);
    else
        mont_mul_kernel<1><<<blocks_for(width), kThreads, 0, s>>>(
            a, b, out, (uint32_t)width);
    return (int)cudaGetLastError();
}

extern "C" int h2v_sqrt_principal(const int32_t* xs, int32_t* ys,
                                  long long width, void* stream) {
    sqrt_principal_kernel<<<blocks_for(width), kThreads, 0,
                            (cudaStream_t)stream>>>(xs, ys,
                                                    (uint32_t)width);
    return (int)cudaGetLastError();
}
