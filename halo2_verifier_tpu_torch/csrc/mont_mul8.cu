// K4: Montgomery multiply on 8-bit limbs in float32.
//
// Replaces halo2_verifier_tpu/ops/lmfield8.py `_mont_mul_pallas` (body
// `_mm_kernel`, which runs `mont_mul_body`), the TPU kernel that
// `lmfield8.mont_mul` dispatches to: the scan MSM's conversion of gathered
// points into Montgomery form when the limb backend is "f8".
//
// out = a * b * 2^-256 mod N on (32, B) float32 rows of canonical limbs,
// integers in [0, 255], for Fq and Fr. The contract is canonical limbs in
// and out; nothing checks it.
//
// Design: the reference computes three float32 convolutions with lazy
// carry folds because its vector unit emulates 32-bit integer multiplies
// and float32 is exact up to 2^24. This card multiplies integers natively,
// so the convolutions are not carried over: one thread per lane packs its
// 32 + 32 float limbs into eight 32-bit words per operand, runs the
// word-serial CIOS product of field.cuh (the one the 16-bit-limb kernel
// runs), and unpacks the canonical result into 32 floats. Montgomery R is
// 2^256 in both formats, so the result is the reference's limb for limb.
//
// Bound on this card: a lane moves 3 x 128 B (2 in, 1 out) for 264
// integer multiply-adds and 64 ALU operations (16 for the product; 8 byte
// permutes per load and 32 per store, the float halves and bytes made by
// 96 FP32 operations, field.cuh Limbs8): ~0.7 multiply-adds per byte,
// under the card's balance point of ~5, so the kernel is bound by bytes,
// twice those of the 16-bit format.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

template <int F>
__global__ void __launch_bounds__(kThreads)
mont_mul8_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, uint32_t width) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    h2v::Fe x = h2v::Limbs8::load(a + i, width);
    h2v::Fe y = h2v::Limbs8::load(b + i, width);
    h2v::Limbs8::store(out + i, width, h2v::mont_mul<F>(x, y));
}

}  // namespace

extern "C" int h2v_mont_mul8(const float* a, const float* b, float* out,
                             long long width, int field, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned int blocks = (unsigned int)((width + kThreads - 1) / kThreads);
    if (field == 0)
        mont_mul8_kernel<0><<<blocks, kThreads, 0, s>>>(a, b, out,
                                                         (uint32_t)width);
    else
        mont_mul8_kernel<1><<<blocks, kThreads, 0, s>>>(a, b, out,
                                                         (uint32_t)width);
    return (int)cudaGetLastError();
}
