// T1-T3: the device pairing's tower kernels (ops/pairing.py).
//
// The reference (halo2_verifier_tpu/ops/pairing_jax.py) has no Pallas
// kernel here: its tower is one jitted XLA program, fused by XLA, whose
// widths (54 lanes per pair) never reach the Pallas K1. Eager PyTorch
// launches every tensor op on its own, so the three pieces that would
// otherwise cost hundreds of small launches each are one launch each:
// - T1 fq_addsub: elementwise Fq add, subtract or negate (pairing_jax
//   `_fadd`/`_fsub`/`_fneg`, `lmfield.add`/`sub`/`neg`); plain versions
//   ops/field.py add_body, sub_body, neg_body;
// - T2 fq_linmap: the exact linear map of pairing_jax `_linear_combine`
//   + `_reduce_mod_p` (the Fq12 multiply's operand maps and its
//   recombination); plain version ops/pairing.py linear_combine_plain;
// - T3 fq_inv: the Fermat inversion of pairing_jax `_finv`
//   (`lmfield.inv_mont`, a lax.scan of Montgomery products); plain
//   version ops/field.py inv_mont_body.
//
// Design: one thread per output lane, on field.cuh's canonical add, sub
// and Montgomery product, so every intermediate is the canonical residue
// and each output equals the plain version's unique canonical result bit
// for bit. T1 reads each operand with its own row stride, so the column
// slices the tower hands it (views into a wider product) need no copy.
// T2's thread (output o, lane i) adds or subtracts x_j |M[o, j]| times
// for each nonzero coefficient (|M[o, j]| at most 10, and its sum over a
// row at most 252, in the Fq12 maps); lanes vary fastest, so a warp
// shares o and its coefficients. T3 runs the square-and-multiply over the
// bits of N - 2, most significant first (253 squarings and 109 products
// for Fq); inv(0) = 0 falls out of it.
//
// Bounds (chip_smoke.py's model, which counts the function and not these
// schedules): T1 and T2 move 64 B per operand and result for a few dozen
// operations (T2: a small-scalar multiply-accumulate per nonzero
// coefficient, one reduction per output), so both are bound by bytes at
// any width that fills the card: 0.0207 ms for each Fq12 map at 16,384
// lanes. The pairing runs them at 1-108 lanes, where a launch costs its
// fixed latency. T3's bound counts the shortest fixed-window chain for
// N - 2 (3 bits for Fq: 253 squarings, 71 products; 12 % fewer
// multiply-adds than the ladder here): bound by operations at a wide
// width, and at the pairing's 1-3 lanes by one warp's chain latency. The
// measured times and shares are in PERF.md.

#include <cuda_runtime.h>

#include "field.cuh"

// N - 2 for Fq and Fr as 32-bit words: the Fermat exponents.
static __constant__ uint32_t INV_EXP[2][8] = {
    {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xefffffffu, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
};

namespace {

constexpr int kThreads = 256;
constexpr int kInvBits = 254;  // bit length of N - 2, both moduli

using h2v::Fe;
using h2v::Limbs16;

enum Op { kAdd = 0, kSub = 1, kNeg = 2 };

__global__ void __launch_bounds__(kThreads)
fq_addsub_kernel(const int32_t* __restrict__ a, uint32_t a_stride,
                 const int32_t* __restrict__ b, uint32_t b_stride,
                 int32_t* __restrict__ out, uint32_t width, int op) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    Fe x = Limbs16::load(a + i, a_stride);
    Fe r;
    if (op == kNeg) {
        Fe zero{};
        r = h2v::sub<0>(zero, x);
    } else {
        Fe y = Limbs16::load(b + i, b_stride);
        r = op == kAdd ? h2v::add<0>(x, y) : h2v::sub<0>(x, y);
    }
    Limbs16::store(out + i, width, r);
}

// x: (16, k, width), m: (n_out, k) int32, out: (16, n_out, width).
__global__ void __launch_bounds__(kThreads)
fq_linmap_kernel(const int32_t* __restrict__ x,
                 const int32_t* __restrict__ m, int32_t* __restrict__ out,
                 uint32_t k, uint32_t n_out, uint32_t width) {
    uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_out * width) return;
    uint32_t o = t / width, i = t - o * width;
    Fe acc{};
#pragma unroll 1
    for (uint32_t j = 0; j < k; ++j) {
        int c = m[o * k + j];
        if (c == 0) continue;
        Fe v = Limbs16::load(x + j * width + i, k * width);
#pragma unroll 1
        for (; c > 0; --c) acc = h2v::add<0>(acc, v);
#pragma unroll 1
        for (; c < 0; ++c) acc = h2v::sub<0>(acc, v);
    }
    Limbs16::store(out + o * width + i, n_out * width, acc);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
fq_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
              uint32_t width) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    const Fe x = Limbs16::load(a + i, width);
    Fe r = x;  // the exponent's top bit
#pragma unroll 1
    for (int bit = kInvBits - 2; bit >= 0; --bit) {
        r = h2v::mont_mul<F>(r, r);
        if ((INV_EXP[F][bit >> 5] >> (bit & 31)) & 1u)
            r = h2v::mont_mul<F>(r, x);
    }
    Limbs16::store(out + i, width, r);
}

unsigned int blocks_for(long long n) {
    return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int h2v_fq_addsub(const int32_t* a, long long a_stride,
                             const int32_t* b, long long b_stride,
                             int32_t* out, long long width, int op,
                             void* stream) {
    fq_addsub_kernel<<<blocks_for(width), kThreads, 0,
                       (cudaStream_t)stream>>>(
        a, (uint32_t)a_stride, b, (uint32_t)b_stride, out, (uint32_t)width,
        op);
    return (int)cudaGetLastError();
}

extern "C" int h2v_fq_linmap(const int32_t* x, const int32_t* m,
                             int32_t* out, long long k, long long n_out,
                             long long width, void* stream) {
    fq_linmap_kernel<<<blocks_for(n_out * width), kThreads, 0,
                       (cudaStream_t)stream>>>(
        x, m, out, (uint32_t)k, (uint32_t)n_out, (uint32_t)width);
    return (int)cudaGetLastError();
}

extern "C" int h2v_fq_inv(const int32_t* a, int32_t* out, long long width,
                          int field, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
        fq_inv_kernel<0><<<blocks_for(width), kThreads, 0, s>>>(
            a, out, (uint32_t)width);
    else
        fq_inv_kernel<1><<<blocks_for(width), kThreads, 0, s>>>(
            a, out, (uint32_t)width);
    return (int)cudaGetLastError();
}
