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
// the package, and unpacks on the store, with exact float-bit identities
// on the FP32 pipe and no F2I/I2F (field.cuh Limbs8). The format costs
// bytes and byte permutes, never another arithmetic. Its body is rolled
// (point.cuh add_rolled): unrolled, its 9k SASS instructions (143 KB)
// outgrow the instruction cache, and the add took 0.60 ms on the scan's
// widest launch against 0.35 rolled (sweep_kernels.py point_add, NVIDIA
// H100 80GB HBM3, 700.00 W).
//
// Bound on this card: the least operation count is that of the 16-bit
// add (3,168 multiply-adds per adding lane) with 32 byte permutes per
// stored element instead of 16 and 32 FP32 operations per element moved,
// and the bytes are twice the 16-bit format's, so the add is bound by
// bytes: a scan level, which reads P and Q from one tensor, moves 773 B
// per lane (4.1 multiply-adds per byte against the card's balance point
// of ~5), an add of two tensors 1,157 B (2.7), and masked lanes only
// copy. Its loads and its arithmetic each take well under its time alone,
// and they overlap little, so it runs at 35 % of its bound (0.3492 ms
// against 0.1229 ms on the scan's widest launch, chip_smoke.py, NVIDIA
// H100 80GB HBM3, 700.00 W).

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
