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
// registers as eight 32-bit words each, and writes X3, Y3, Z3 once.
//
// Bound on this card: a lane moves up to 584 B (two gathered 192 B points,
// 8 B of indices, 192 B written; a forest level reads its frontier about
// once over the launch, which halves the reads) and needs at least 4,152
// 32-bit integer operations (12 Montgomery products of 280 with fused
// multiply-add carry chains, 27 modular adds/subtracts of 24, packing of
// 9 elements): 7-11 op/B against the card's ~5 op/B balance point, so the
// add is bound by integer throughput, as the TPU kernel was (~55k VPU
// operations per add in the reference's own count, bench.py). The 32-bit
// CIOS cuts that count several-fold; bringing the kernel closer to the
// card's rate (PTX carry chains, more independent work per warp) is later
// work.

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
