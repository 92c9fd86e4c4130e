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
// needs at least 2,112 integer multiply-adds (8 Montgomery products of
// 264) and 536 ALU operations (the products' subtracts, 14 modular
// adds/subtracts of 24, packing of 6 elements): ~5.5 multiply-adds per
// byte against the card's balance point of ~5, so the doubling is bound
// by the FMA pipe's multiply-adds, by less than the add is.

#include "point.cuh"

namespace {

constexpr int kThreads = 128;

using h2v::Fe;
using h2v::Limbs16;
using h2v::fq_add;
using h2v::fq_mul;
using h2v::fq_sub;

__global__ void __launch_bounds__(kThreads)
point_double_kernel(const int32_t* __restrict__ px,
                    const int32_t* __restrict__ py,
                    const int32_t* __restrict__ pz,
                    int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                    int32_t* __restrict__ oz, uint32_t width) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    Fe X = Limbs16::load(px + i, width);
    Fe Y = Limbs16::load(py + i, width);
    Fe Z = Limbs16::load(pz + i, width);

    Fe t0 = fq_mul(Y, Y);
    Fe t1 = fq_mul(Y, Z);
    Fe t2 = h2v::fq_mul_b3(fq_mul(Z, Z));
    Fe t3 = fq_mul(X, Y);
    Fe z3 = fq_add(fq_add(t0, t0), fq_add(t0, t0));
    z3 = fq_add(z3, z3);
    Fe y3 = fq_add(t0, t2);
    Fe t0m = fq_sub(t0, fq_add(fq_add(t2, t2), t2));
    Fe x3 = fq_mul(t0m, t3);
    Limbs16::store(ox + i, width, fq_add(x3, x3));
    Limbs16::store(oy + i, width, fq_add(fq_mul(t2, z3), fq_mul(t0m, y3)));
    Limbs16::store(oz + i, width, fq_mul(t1, z3));
}

}  // namespace

extern "C" int h2v_point_double(const int32_t* px, const int32_t* py,
                                const int32_t* pz, int32_t* ox, int32_t* oy,
                                int32_t* oz, long long width, void* stream) {
    unsigned int blocks = (unsigned int)((width + kThreads - 1) / kThreads);
    point_double_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        px, py, pz, ox, oy, oz, (uint32_t)width);
    return (int)cudaGetLastError();
}
