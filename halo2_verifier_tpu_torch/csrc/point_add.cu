// K2: the fused, masked complete point add, with the gather fused in.
//
// Replaces halo2_verifier_tpu/ops/lmcurve.py `PointOps._make_masked_add`
// (`kernel` + `run`, the OPS16 instance), which every forest level,
// bucket-tree fold and Horner step of the main path reaches through
// `OPS16.add`, and the two gathers that fed it (msm_forest.py `_level_add`).
//
// out[i] = mask[i] ? P[i] + Q[i] : P[i], P[i] = p[:, iL[i]] (or p[:, i]),
// Q[i] = q[:, iR[i]] (or q[:, i]), with the complete Renes-Costello-Batina
// 2015 addition for a = 0 (algorithm 7) in exactly the reference's
// operation order (lmcurve.PointOps.add_body), so projective outputs equal
// the reference's bit for bit. Complete: identity + identity, P + P and
// P + (-P) need no branch, which the planner's (identity, identity)
// padding lanes rely on.
//
// Design (the kernel itself is point.cuh `point_add_kernel`, shared with
// the 8-bit-limb entry of point_add8.cu): one thread per output lane. It
// reads its two input points straight from the frontier by index (the TPU
// path materialized both gathers in HBM first), keeps all intermediates in
// registers as eight 32-bit words each, and writes X3, Y3, Z3 once. The
// field arithmetic is PTX carry chains on 32-bit words (field.cuh); rows
// are addressed in 32 bits from the lane's own pointer. The body is
// unrolled, launched as 256 threads x 2 blocks per SM (128 registers, no
// spill, 16 warps per SM), the fastest shape of sweep_kernels.py
// point_add.
//
// Bound on this card: a lane moves up to 584 B (two gathered 192 B points,
// 8 B of indices, 192 B written; a forest level reads its frontier about
// once over the launch, which halves the reads) and needs at least 3,168
// integer multiply-adds on the FMA pipe (12 Montgomery products of 264
// with fused carry chains) and 936 ALU operations (the products'
// subtracts, 27 modular adds/subtracts of 24, 8 per load and 16 per store
// of an element): 5-11 multiply-adds per byte against the card's balance
// point of ~5, so the add is bound by the FMA pipe's multiply-adds, as
// the TPU kernel was bound by its arithmetic (~55k VPU operations per add
// in the reference's own count, bench.py). It issues 8,096 SASS
// instructions per adding lane: on sm_90 ptxas turns each PTX madc into
// an IMAD and an IADD3.X, so a word product costs 2 IMADs on the FMA pipe
// and 2 IADD3s on the ALU pipe, which then carries as much as the FMA pipe
// (3,734 IMAD; 3,788 IADD3, SEL, LOP3, PRMT); issuing 8,096 at 128 per
// clock takes 1.28x the bound. On an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py) it runs at 39-42 % of its bound: 0.1306 ms on the
// forest's widest launch (266,240 lanes, 38.6 % of 0.0504 ms) and 0.2350
// ms on the scan's (532,480 lanes, 41.7 % of 0.0979 ms).

#include "point.cuh"

extern "C" int h2v_point_add(const int32_t* px, const int32_t* py,
                             const int32_t* pz, long long wp,
                             const int32_t* qx, const int32_t* qy,
                             const int32_t* qz, long long wq,
                             const int32_t* il, const int32_t* ir,
                             const uint8_t* mask, int32_t* ox, int32_t* oy,
                             int32_t* oz, long long width, void* stream) {
    return h2v::launch_point_add<h2v::Limbs16>(
        px, py, pz, wp, qx, qy, qz, wq, il, ir, mask, ox, oy, oz, width,
        stream);
}
