// The forest MSM's level-0 frontier in one launch: canonical affine limbs
// and the plan's gather index in, projective Montgomery points out.
//
// Replaces K1's use in halo2_verifier_tpu/ops/msm_forest.py
// `_convert_points` (two `lmfield.mont_mul` launches, then
// `lmcurve.from_affine`) and `_gather0` (the gather of the level-0
// frontier by `point_idx0`), as `dispatch_planned` runs them one after the
// other. Plain version: ops/msm_forest.py frontier0_plain.
//
// out[:, i] = convert(xs[:, idx[i]], ys[:, idx[i]]): x R mod q, y R mod q,
// Z = R mod q; a (0, 0) source lane (the identity pad included) becomes
// the identity (0 : R mod q : 0), as from_affine does on the converted
// coordinates.
//
// Bound on this card: the main path writes a 524,288-lane frontier from
// 17,408 points: 3 x 64 B per output lane, ~100 MB, ~0.031 ms at
// 3.35 TB/s; the two Montgomery products per point are ~0.001 ms. So it
// is bound by the bytes it writes, if each output lane reads its point
// in few memory sectors. In the limbs-major source a point's 16 limbs
// lie in 16 rows, so a gathered lane reads 32 sectors of 32 B for 128 B
// of limbs (~540 MB through L2 for the frontier; this kernel's first
// design, which gathered there, ran at 4.5x the bound: PERF.md).
//
// Design: one cooperative launch in two phases. Phase 1 converts every
// source point once (coalesced rows in) into a point-major scratch of
// packed words (64 B per point: x then y, 1.1 MB on the main path, in
// L2); the grid synchronizes; phase 2 gathers each output lane's point as
// four 16-byte loads (two sectors), selects the identity, and writes the
// frontier rows coalesced. The grid is as large as the card holds at
// once (a cooperative launch needs every block resident); both phases
// stride over it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"

// Fq constants as 32-bit words: R^2 mod q and R mod q (one).
static __constant__ uint32_t R2_FQ[8] = {
    0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
    0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u};
static __constant__ uint32_t ONE_FQ[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};

namespace {

using h2v::Fe;
using h2v::Limbs16;

constexpr int kThreads = 256;

__device__ __forceinline__ Fe from_const(const uint32_t* c) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = c[j];
    return r;
}

__global__ void __launch_bounds__(kThreads)
frontier0_kernel(const int32_t* __restrict__ xs,
                 const int32_t* __restrict__ ys, uint32_t n,
                 const int32_t* __restrict__ idx, int32_t* __restrict__ X,
                 int32_t* __restrict__ Y, int32_t* __restrict__ Z,
                 uint32_t w0, uint4* __restrict__ pts) {
    const uint32_t stride = gridDim.x * blockDim.x;
    const uint32_t t0 = blockIdx.x * blockDim.x + threadIdx.x;
    const Fe r2 = from_const(R2_FQ);
    for (uint32_t s = t0; s < n; s += stride) {
        Fe gx = h2v::mont_mul<0>(Limbs16::load(xs + s, n), r2);
        Fe gy = h2v::mont_mul<0>(Limbs16::load(ys + s, n), r2);
        uint4* p = pts + 4 * s;
        p[0] = make_uint4(gx.w[0], gx.w[1], gx.w[2], gx.w[3]);
        p[1] = make_uint4(gx.w[4], gx.w[5], gx.w[6], gx.w[7]);
        p[2] = make_uint4(gy.w[0], gy.w[1], gy.w[2], gy.w[3]);
        p[3] = make_uint4(gy.w[4], gy.w[5], gy.w[6], gy.w[7]);
    }
    cooperative_groups::this_grid().sync();
    const Fe one = from_const(ONE_FQ);
    const Fe zero = {{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
    for (uint32_t i = t0; i < w0; i += stride) {
        const uint4* p = pts + 4 * (uint32_t)__ldg(idx + i);
        uint4 a = p[0], b = p[1], c = p[2], d = p[3];
        Fe gx = {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
        Fe gy = {{c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w}};
        uint32_t nz = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) nz |= gx.w[j] | gy.w[j];
        Limbs16::store(X + i, w0, nz ? gx : zero);
        Limbs16::store(Y + i, w0, nz ? gy : one);
        Limbs16::store(Z + i, w0, nz ? one : zero);
    }
}

}  // namespace

// scratch: n x 64 bytes, 16-byte aligned (the point-major converted
// points).
extern "C" int h2v_forest_frontier0(const int32_t* xs, const int32_t* ys,
                                    long long n, const int32_t* idx,
                                    int32_t* X, int32_t* Y, int32_t* Z,
                                    long long w0, void* scratch,
                                    void* stream) {
    int dev, sms, per_sm;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frontier0_kernel,
                                                  kThreads, 0);
    long long need = ((n > w0 ? n : w0) + kThreads - 1) / kThreads;
    long long fit = (long long)sms * per_sm;
    unsigned int grid = (unsigned int)(need < fit ? need : fit);
    uint32_t n32 = (uint32_t)n, w32 = (uint32_t)w0;
    uint4* pts = (uint4*)scratch;
    void* args[] = {(void*)&xs, (void*)&ys, (void*)&n32, (void*)&idx,
                    (void*)&X,  (void*)&Y,  (void*)&Z,   (void*)&w32,
                    (void*)&pts};
    cudaError_t rc = cudaLaunchCooperativeKernel(
        (void*)frontier0_kernel, grid, kThreads, args, 0,
        (cudaStream_t)stream);
    cudaError_t last = cudaGetLastError();
    return (int)(rc != cudaSuccess ? rc : last);
}
