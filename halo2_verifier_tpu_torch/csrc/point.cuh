// Complete BN254 G1 point arithmetic on h2v::Fe, shared by the point
// kernels: the masked add in both limb formats (point_add.cu,
// point_add8.cu) and the doubling (point_double.cu).
//
// Both bodies are the Renes-Costello-Batina 2015 complete formulas for
// a = 0 in exactly the reference's operation order
// (halo2_verifier_tpu/ops/lmcurve.py PointOps.add_body and double_body), on
// canonical residues, so projective outputs equal the reference's bit for
// bit in either format: the limb format changes how an element is read
// and written, never its value.

#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

namespace h2v {

constexpr int kPointThreads = 128;

__device__ __forceinline__ Fe fq_mul(const Fe& a, const Fe& b) {
    return mont_mul<0>(a, b);
}
__device__ __forceinline__ Fe fq_add(const Fe& a, const Fe& b) {
    return add<0>(a, b);
}
__device__ __forceinline__ Fe fq_sub(const Fe& a, const Fe& b) {
    return sub<0>(a, b);
}

// x * 3b = x * 9 by the reference's add chain
__device__ __forceinline__ Fe fq_mul_b3(const Fe& x) {
    Fe d1 = fq_add(x, x);
    Fe d2 = fq_add(d1, d1);
    Fe d3 = fq_add(d2, d2);
    return fq_add(d3, x);
}

// out[i] = mask[i] ? P[i] + Q[i] : P[i], P[i] = p[:, il[i]] (or p[:, i]),
// Q[i] = q[:, ir[i]] (or q[:, i]); one thread per output lane, every
// intermediate in registers. A masked-out lane never reads Q. L is the
// limb format (Limbs16 or Limbs8).
template <class L>
__global__ void __launch_bounds__(kPointThreads)
point_add_kernel(const typename L::T* __restrict__ px,
                 const typename L::T* __restrict__ py,
                 const typename L::T* __restrict__ pz, long long wp,
                 const typename L::T* __restrict__ qx,
                 const typename L::T* __restrict__ qy,
                 const typename L::T* __restrict__ qz, long long wq,
                 const int32_t* __restrict__ il,
                 const int32_t* __restrict__ ir,
                 const uint8_t* __restrict__ mask,
                 typename L::T* __restrict__ ox,
                 typename L::T* __restrict__ oy,
                 typename L::T* __restrict__ oz, long long width) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    long long l = il ? (long long)il[i] : i;
    Fe X1 = L::load(px, wp, l);
    Fe Y1 = L::load(py, wp, l);
    Fe Z1 = L::load(pz, wp, l);
    if (mask && !mask[i]) {
        L::store(ox, width, i, X1);
        L::store(oy, width, i, Y1);
        L::store(oz, width, i, Z1);
        return;
    }
    long long r = ir ? (long long)ir[i] : i;
    Fe X2 = L::load(qx, wq, r);
    Fe Y2 = L::load(qy, wq, r);
    Fe Z2 = L::load(qz, wq, r);

    Fe t0 = fq_mul(X1, X2);
    Fe t1 = fq_mul(Y1, Y2);
    Fe t2 = fq_mul(Z1, Z2);
    Fe t3 = fq_sub(fq_mul(fq_add(X1, Y1), fq_add(X2, Y2)), fq_add(t0, t1));
    Fe t4 = fq_sub(fq_mul(fq_add(Y1, Z1), fq_add(Y2, Z2)), fq_add(t1, t2));
    Fe y3 = fq_sub(fq_mul(fq_add(X1, Z1), fq_add(X2, Z2)), fq_add(t0, t2));
    Fe t2b = fq_mul_b3(t2);
    Fe x3 = fq_add(fq_add(t0, t0), t0);
    Fe z3 = fq_add(t1, t2b);
    Fe t1m = fq_sub(t1, t2b);
    Fe y3b = fq_mul_b3(y3);
    L::store(ox, width, i, fq_sub(fq_mul(t3, t1m), fq_mul(t4, y3b)));
    L::store(oy, width, i, fq_add(fq_mul(y3b, x3), fq_mul(t1m, z3)));
    L::store(oz, width, i, fq_add(fq_mul(z3, t4), fq_mul(x3, t3)));
}

template <class L>
int launch_point_add(const typename L::T* px, const typename L::T* py,
                     const typename L::T* pz, long long wp,
                     const typename L::T* qx, const typename L::T* qy,
                     const typename L::T* qz, long long wq,
                     const int32_t* il, const int32_t* ir,
                     const uint8_t* mask, typename L::T* ox,
                     typename L::T* oy, typename L::T* oz, long long width,
                     void* stream) {
    unsigned int blocks =
        (unsigned int)((width + kPointThreads - 1) / kPointThreads);
    point_add_kernel<L><<<blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
        px, py, pz, wp, qx, qy, qz, wq, il, ir, mask, ox, oy, oz, width);
    return (int)cudaGetLastError();
}

}  // namespace h2v
