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
// Square root, design: the radix-2^29 arithmetic of mont29.cuh (limbs
// with 64-bit column sums, lazy reduction, a dedicated squaring, a fixed
// window over the constant exponent), and:
// - a window of SqrtShape::kWindow bits: with 4 bits, 249 squarings and
//   69 multiplies (13 for the table base^1..base^15) instead of 251 and
//   109; 322 products per lane with the three of x^3 + 3 and the one out
//   of Montgomery form (ops/decomp.py sqrt_chain_counts);
// - blocks of SqrtShape::kThreads = 64 threads spread the 480 warps over
//   all 132 SMs (256-thread blocks fill 60 SMs with 2 warps per
//   scheduler: 1.56x the time), one lane per thread.
// The shape was chosen on the card by sweep_kernels.py sqrt; the numbers
// are in PERF.md.

#include <cuda_runtime.h>

#include "field.cuh"
#include "mont29.cuh"

// (q + 1) / 4 as 32-bit words.
static __constant__ uint32_t SQRT_EXP[8] = {
    0xb61f3f52u, 0x4f082305u, 0x5a1c72a3u, 0x65e05aa4u,
    0xa0605617u, 0x6e14116du, 0xb84c680au, 0x0c19139cu};

// R' = 2^261 constants in radix 2^29 (mont29.cuh): R'^2 mod q and 3R' mod q
// (the curve's b in this Montgomery form).
static __constant__ uint32_t R2_29[9] = {
    0x059bac10u, 0x0d1503a3u, 0x018016b8u, 0x10ab0ca8u, 0x02632639u,
    0x02c0169fu, 0x169bfd53u, 0x11869d4cu, 0x002a11a6u};
static __constant__ uint32_t B3_29[9] = {
    0x00766463u, 0x1c54760au, 0x08f6927au, 0x03e40c4du, 0x1fea4f2bu,
    0x17c6c26au, 0x157fe417u, 0x0f8056f9u, 0x002958a2u};

namespace {

using h2v::E29;
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
        E29 x = h2v::from_words(Limbs16::load(xs + i, width));
        E29 xm = h2v::mul29<0>(x, h2v::from_const29(R2_29));
        E29 x3 = h2v::mul29<0>(h2v::sqr29<0>(xm), xm);
#pragma unroll
        for (int j = 0; j < 9; ++j) x3.l[j] += B3_29[j];
        r[l] = h2v::normalize29(x3);
    }
    h2v::pow_window29<0, W, L, kSqrtBits>(r, SQRT_EXP);
#pragma unroll
    for (int l = 0; l < L; ++l) {
        uint32_t i = t + l * n;
        // at most q: exact limbs, words, one conditional subtract
        if (i < width)
            Limbs16::store(ys + i, width, h2v::cond_sub<0>(h2v::to_words(
                h2v::normalize29(h2v::from_mont29<0>(r[l])))));
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

// The square root as above, then, from the same call, an H2D copy of
// `bytes` from pinned `src` to `dst` queued on `copy_stream` and the event
// `done` recorded after it: with no host latency between the two, the
// copy runs on the card beside the kernel.
extern "C" int h2v_sqrt_principal_beside(const int32_t* xs, int32_t* ys,
                                         long long width, void* stream,
                                         void* dst, const void* src,
                                         long long bytes, void* copy_stream,
                                         void* done) {
    int rc = h2v_sqrt_principal(xs, ys, width, stream);
    if (rc != 0) return rc;
    cudaStream_t cs = (cudaStream_t)copy_stream;
    rc = (int)cudaMemcpyAsync(dst, src, (size_t)bytes,
                              cudaMemcpyHostToDevice, cs);
    if (rc != 0) return rc;
    return (int)cudaEventRecord((cudaEvent_t)done, cs);
}
