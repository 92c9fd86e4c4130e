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
// the 8-bit-limb entry of point_add8.cu; narrow launches below): one
// thread per output lane. It
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
//
// Narrow shape (point.cuh NarrowShape, narrow::point_add_kernel): below
// 18,432 add lanes (the chain's deep forest levels, its bucket-tree folds
// from 16,384 lanes down and its 64-lane Horner steps) the wide shape
// leaves most of the card idle and each lane waits on one thread's 12
// serial Montgomery products (~1 us each): 12.8 us at 64 lanes, ~17-18 at
// 512-16,384. The formula's multiplicative depth is 2 (6 independent
// products, adds, 6 independent products), so a group of 8 threads of one
// warp computes a lane: one product of each layer per thread, the first
// layer's results exchanged by warp shuffles, the adds between the layers
// repeated in every thread, and 3 threads storing one coordinate each.
// Bound there: the critical path of 2 products, the adds and ~8 exchanges
// of 8 words, not the pipes (64 lanes need 0.1 % of the card's
// multiply-adds); it runs 4.3 us at 64 lanes and 6.1 at 4,096 (2,565
// SASS instructions a thread, 80 registers). It issues ~2.5x the wide
// shape's instructions per lane (8 threads of 2 products and 18 adds
// against one of 12 and 27), so once the card fills the wide shape wins;
// both give the same bits.
//
// Scatter lanes (h2v_point_add_scatter, the packed forest chain of
// ops/msm_forest.py packed_chain): a forest level's launch, which reads
// frontier f_l, also writes level l's finished part into the bucket grid.
// Lanes past the add width each copy one entry, g[:, key[j]] =
// f_l[:, pos[j]] with Y := R where Y = Z = 0 (point.cuh scatter_lane), so
// the chain needs no gather, concatenation or scatter of its own; the
// deepest part, read from the last frontier, is a launch of scatter
// lanes alone. Keys repeat only at the grid's last slot, the dump that
// takes the identity padding and that nothing reads, so the lanes'
// unordered writes there do not matter. Bound: a scatter lane moves 384 B
// (a 192 B point read by index, 192 B written by key) and does no
// multiply-add; a main-path batch (random scalars in groups of 1,024 and
// 15,616) has ~31,000 of them over its ten parts against ~626,000 add
// lanes: ~12 MB, ~4 us at the card's 3.35 TB/s, spread over launches
// whose add lanes take longer.

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

// Launches of either entry with fewer add lanes than this take the narrow
// shape (point.cuh NarrowShape); ops/kernels.py counts them by it.
extern "C" int h2v_point_add_narrow_below() {
    return h2v::NarrowShape::kBelow;
}

// One forest level of the packed chain with its finished part: width add
// lanes out[i] = f[:, il[i]] + f[:, ir[i]] (width 0: none, il and ir
// unread) and nscat scatter lanes g[:, key[j]] = f[:, pos[j]] (Y := R
// where Y = Z = 0) into the (16, wg) grid rows gx, gy, gz.
extern "C" int h2v_point_add_scatter(const int32_t* fx, const int32_t* fy,
                                     const int32_t* fz, long long wf,
                                     const int32_t* il, const int32_t* ir,
                                     int32_t* ox, int32_t* oy, int32_t* oz,
                                     long long width, const int32_t* pos,
                                     const int32_t* key, long long nscat,
                                     int32_t* gx, int32_t* gy, int32_t* gz,
                                     long long wg, void* stream) {
    h2v::PartScatter<h2v::Limbs16> sc = {pos, key, gx, gy, gz,
                                         (uint32_t)nscat, (uint32_t)wg};
    return h2v::launch_point_add<h2v::Limbs16>(
        fx, fy, fz, wf, fx, fy, fz, wf, il, ir, nullptr, ox, oy, oz, width,
        stream, sc);
}

// The nodes of the graph being captured on `stream`, by type: counts[0]
// kernels, counts[1] copies (memcpy), counts[2] memsets, counts[3] any
// other. Fails (cudaErrorIllegalState) if no capture is running there.
extern "C" int h2v_capture_nodes(void* stream, long long* counts) {
    cudaStreamCaptureStatus status;
    unsigned long long id = 0;
    cudaGraph_t graph = nullptr;
    cudaError_t rc =
        cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id, &graph);
    if (rc != cudaSuccess) return (int)rc;
    if (status != cudaStreamCaptureStatusActive || graph == nullptr)
        return (int)cudaErrorIllegalState;
    size_t n = 0;
    rc = cudaGraphGetNodes(graph, nullptr, &n);
    if (rc != cudaSuccess) return (int)rc;
    cudaGraphNode_t* nodes = new cudaGraphNode_t[n ? n : 1];
    rc = cudaGraphGetNodes(graph, nodes, &n);
    for (int k = 0; k < 4; ++k) counts[k] = 0;
    for (size_t i = 0; rc == cudaSuccess && i < n; ++i) {
        cudaGraphNodeType type;
        rc = cudaGraphNodeGetType(nodes[i], &type);
        counts[type == cudaGraphNodeTypeKernel   ? 0
               : type == cudaGraphNodeTypeMemcpy ? 1
               : type == cudaGraphNodeTypeMemset ? 2
                                                 : 3] += 1;
    }
    delete[] nodes;
    return (int)rc;
}
