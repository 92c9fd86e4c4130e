// K3: the complete point doubling.
//
// Replaces halo2_verifier_tpu/ops/lmcurve.py `_double_pallas` (body
// `_double_kernel`, which runs `OPS16.double_body`), the TPU kernel that
// the module-level `lmcurve.double` dispatches to.
//
// out[i] = 2 * P[i] with the complete Renes-Costello-Batina 2015 doubling
// for a = 0 (algorithm 9) in exactly the reference's operation order, so
// the projective output equals the reference's bit for bit; the identity
// (0:1:0) doubles to itself without a branch.
//
// Design: one thread per lane; the three coordinates are packed into eight
// 32-bit words each as they load, all intermediates stay in registers, and
// X3, Y3, Z3 are written once.
//
// Bound on this card: a lane moves 384 B (one 192 B point in, one out) and
// needs at least 2,672 32-bit integer operations (8 Montgomery products of
// 280, 14 modular adds/subtracts of 24, packing of 6 elements): ~7 op/B
// against the card's ~5 op/B balance point, so the doubling is bound by
// integer throughput, by less than the add is.

#include "point.cuh"

namespace {

using h2v::Fe;
using h2v::fq_add;
using h2v::fq_mul;
using h2v::fq_sub;

__global__ void __launch_bounds__(h2v::kPointThreads)
point_double_kernel(const int32_t* __restrict__ px,
                    const int32_t* __restrict__ py,
                    const int32_t* __restrict__ pz,
                    int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                    int32_t* __restrict__ oz, long long width) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    Fe X = h2v::load_fe(px, width, i);
    Fe Y = h2v::load_fe(py, width, i);
    Fe Z = h2v::load_fe(pz, width, i);

    Fe t0 = fq_mul(Y, Y);
    Fe t1 = fq_mul(Y, Z);
    Fe t2 = h2v::fq_mul_b3(fq_mul(Z, Z));
    Fe t3 = fq_mul(X, Y);
    Fe z3 = fq_add(fq_add(t0, t0), fq_add(t0, t0));
    z3 = fq_add(z3, z3);
    Fe y3 = fq_add(t0, t2);
    Fe t0m = fq_sub(t0, fq_add(fq_add(t2, t2), t2));
    Fe x3 = fq_mul(t0m, t3);
    h2v::store_fe(ox, width, i, fq_add(x3, x3));
    h2v::store_fe(oy, width, i,
                  fq_add(fq_mul(t2, z3), fq_mul(t0m, y3)));
    h2v::store_fe(oz, width, i, fq_mul(t1, z3));
}

}  // namespace

extern "C" int h2v_point_double(const int32_t* px, const int32_t* py,
                                const int32_t* pz, int32_t* ox, int32_t* oy,
                                int32_t* oz, long long width, void* stream) {
    unsigned int blocks = (unsigned int)(
        (width + h2v::kPointThreads - 1) / h2v::kPointThreads);
    point_double_kernel<<<blocks, h2v::kPointThreads, 0,
                          (cudaStream_t)stream>>>(px, py, pz, ox, oy, oz,
                                                  width);
    return (int)cudaGetLastError();
}
