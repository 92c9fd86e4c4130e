// K5: the fused, masked complete point add on 8-bit limbs in float32.
//
// Replaces halo2_verifier_tpu/ops/lmcurve.py `PointOps._make_masked_add`
// (`kernel` + `run`), the OPS8 instance, which the scan MSM's segmented
// scan and bucket suffix scans reach through `OPS8.masked_add` when the
// limb backend is "f8", and the rolled copy of the three coordinate
// arrays that fed it at every scan level (msm_jax.py
// `_segmented_inclusive_scan`).
//
// out[i] = mask[i] ? P[i] + Q[i] : P[i], P[i] = p[:, iL[i]] (or p[:, i]),
// Q[i] = q[:, iR[i]] (or q[:, i]): the interface of the 16-bit-limb add
// (point_add.cu) on (32, W) float32 rows of canonical limbs, integers in
// [0, 255]. The contract is canonical limbs in and out; nothing checks it.
//
// Design: the same kernel as the 16-bit-limb add (point.cuh
// `point_add_kernel`), instantiated for the float32 format. The
// reference's float32 format exists because its vector unit emulates
// 32-bit integer multiplies; this card multiplies integers natively, so a
// lane packs its 32 float limbs into eight 32-bit words as it loads them,
// runs the same word-serial Montgomery products as every other kernel of
// the package, and unpacks on the store. The format costs conversions and
// bytes, never another arithmetic.
//
// Bound on this card: the least operation count is that of the 16-bit
// add with 32 conversions per element instead of 16 (4,296 per lane), and
// the bytes are twice the 16-bit format's, so the add sits at the card's
// ~5 op/B balance point. A scan level, which reads P and Q from one
// tensor, moves 773 B per lane (5.6 op/B: bound by operations, by a
// little); an add of two tensors moves 1,157 B (3.7 op/B: bound by
// bytes); masked lanes, which only copy, push either towards bytes.

#include "point.cuh"

extern "C" int h2v_point_add8(const float* px, const float* py,
                              const float* pz, long long wp,
                              const float* qx, const float* qy,
                              const float* qz, long long wq,
                              const int32_t* il, const int32_t* ir,
                              const uint8_t* mask, float* ox, float* oy,
                              float* oz, long long width, void* stream) {
    return h2v::launch_point_add<h2v::Limbs8>(
        px, py, pz, wp, qx, qy, qz, wq, il, ir, mask, ox, oy, oz, width,
        stream);
}
