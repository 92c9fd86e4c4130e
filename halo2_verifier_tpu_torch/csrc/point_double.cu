// K3: the complete point doubling.
//
// Replaces halo2_verifier_tpu/ops/lmcurve.py `_double_pallas` (body
// `_double_kernel`, which runs `OPS16.double_body`), the TPU kernel that
// the module-level `lmcurve.double` dispatches to.
//
// out[i] = 2 * P[i] with the complete Renes-Costello-Batina 2015 doubling
// for a = 0 (algorithm 9): t0 = Y^2, t1 = Y Z, t2 = 9 Z^2, t3 = X Y,
// z3 = 8 t0, y3 = t0 + t2, t0m = t0 - 3 t2, X3 = 2 t0m t3, Y3 = t2 z3 +
// t0m y3, Z3 = t1 z3. Every output is the canonical residue, which is
// unique, so any formulas for the same residues equal the reference's
// projective triple bit for bit; the identity (0:1:0) doubles to itself
// without a branch.
//
// Bound on this card (chip_smoke.py OPS_POINT_DOUBLE): a lane moves 384 B
// (three 64 B coordinates in, three out) and needs at least 1,864 integer
// multiply-adds: two squarings (208 each), six products (264 each) less
// the one reduction that Y3's two products share (136), with 12 modular
// adds. At 524,288 lanes that is 0.0584 ms of the FMA pipe against 0.0601
// ms of bytes, so the doubling is bound by bytes, barely: the kernel has
// to keep its loads in flight while it computes.
//
// Design: one thread per lane; every row read and written coalesced
// across the warp (lane i of row k at k * W + i); the three coordinates
// packed into eight 32-bit words as they load, split into radix-2^29
// limbs (mont29.cuh: 64-bit column sums, values lazy; see double_r29 for
// the scaling that absorbs the 2^-5 of each product's R' = 2^261 and for
// every intermediate's bound), X3, Y3, Z3 written once. DoubleShape was
// chosen on the card by sweep_kernels.py point_double (PERF.md, which
// also holds the times of a 32-bit-word CIOS build of the same schedule).

#include "mont29.cuh"
#include "point.cuh"

namespace {

struct DoubleShape {
    static constexpr int kThreads = 128;
    static constexpr int kMinBlocks = 4;
};

using h2v::E29;
using h2v::Fe;
using h2v::Limbs16;

// 68 N in radix-2^29 limbs with 2^31 added to limbs 0-7 and 4 taken from
// each limb above, the same value: t0m = t0 + 68 N - 3 t2 limb by limb
// stays non-negative (3 t2 has limbs below 3 * 2^29 and value below
// 67.9 N). tests/test_torch_point_double.py checks the value.
__constant__ uint32_t BIAS29[9] = {
    0x813346dcu, 0x8529b088u, 0x8e7360fau, 0x809d3f78u, 0x978dc3e2u,
    0x823d3329u, 0x8c53d546u, 0x907a25cdu, 0x0cdaa4d2u};

// The canonical words of a lazy value below (kSubs + 1) N < 2^256.
template <int kSubs>
__device__ __forceinline__ Fe words29(const E29& a) {
    Fe r = h2v::to_words(h2v::normalize29(a));
#pragma unroll
    for (int k = 0; k < kSubs; ++k) r = h2v::cond_sub<0>(r);
    return r;
}

// The doubling on radix-2^29 limbs. A product there is
// a b 2^-261 = a b 2^-256 2^-5: in the data's Montgomery form (R = 2^256)
// it carries 2^-5, and an output, degree 4 and two products deep, 2^-15.
// The inputs are read as 16 X, 16 Y, 16 Z (a 4-bit shift as they are
// split into limbs), so every first product carries 16^2 2^-5 = 8; then
// X3 = 2 t0m t3 comes out as t0m t3 (8 * 8 * 2^-5 = 2), and Z3 = t1 z3
// and Y3 = t2 z3 + t0m y3 come out exact from z3 / 2 = 4 t0 and y3 / 2
// (half29). Bounds, with rho = N / 2^261 < 0.0060 (each product below
// a b / 2^261 + N, tests/test_torch_point_double.py checks them at the
// limbs' maxima):
// - inputs below 16 N, exact limbs; t0, Z^2, t1, t3 below 2.52 N;
// - t2 = 9 Z^2 < 22.7 N, z3 / 2 < 10.1 N, t0m = t0 + 68 N - 3 t2 < 70.6 N,
//   all exact limbs; y3 / 2 < 13.1 N, limbs below 2^30;
// - X3 < 2.05 N (two conditional subtracts), Z3 < 1.15 N (one), Y3 < 7.8
//   N (reduce_top29, then one).
__device__ __forceinline__ void double_r29(const Fe& X, const Fe& Y,
                                           const Fe& Z, Fe& X3, Fe& Y3,
                                           Fe& Z3) {
    using namespace h2v;
    const E29 x = from_words<4>(X);
    const E29 y = from_words<4>(Y);
    const E29 z = from_words<4>(Z);
    const E29 e0 = normalize29(sqr29<0>(y));
    const E29 ez = normalize29(sqr29<0>(z));
    const E29 t1 = mul29<0>(y, z);
    const E29 t3 = mul29<0>(x, y);
    const E29 ez8 = shl29<3>(ez);
    E29 t2, y3, t0m;
#pragma unroll
    for (int j = 0; j < 9; ++j) t2.l[j] = ez8.l[j] + ez.l[j];
    t2 = normalize29(t2);
    const E29 z3h = shl29<2>(e0);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
        y3.l[j] = e0.l[j] + t2.l[j];
        t0m.l[j] = e0.l[j] + BIAS29[j] - 3 * t2.l[j];
    }
    const E29 y3h = half29<0>(y3);
    t0m = normalize29(t0m);
    X3 = words29<2>(mul29<0>(t0m, t3));
    Y3 = cond_sub<0>(to_words(reduce_top29<0>(mul2_29<0>(t2, z3h, t0m,
                                                         y3h))));
    Z3 = words29<1>(mul29<0>(t1, z3h));
}

// One lane per thread. (Warps walking 32-lane tiles with the next tile's
// rows copied into shared memory by cp.async while the tile before
// computes, and a grid-stride loop with the next lane prefetched into L2,
// both ran slower on the card: PERF.md.)
__global__ void __launch_bounds__(DoubleShape::kThreads,
                                  DoubleShape::kMinBlocks)
point_double_kernel(const int32_t* __restrict__ px,
                    const int32_t* __restrict__ py,
                    const int32_t* __restrict__ pz,
                    int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                    int32_t* __restrict__ oz, uint32_t width) {
    const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    const Fe X = Limbs16::load(px + i, width);
    const Fe Y = Limbs16::load(py + i, width);
    const Fe Z = Limbs16::load(pz + i, width);
    Fe X3, Y3, Z3;
    double_r29(X, Y, Z, X3, Y3, Z3);
    Limbs16::store(ox + i, width, X3);
    Limbs16::store(oy + i, width, Y3);
    Limbs16::store(oz + i, width, Z3);
}

}  // namespace

extern "C" int h2v_point_double(const int32_t* px, const int32_t* py,
                                const int32_t* pz, int32_t* ox, int32_t* oy,
                                int32_t* oz, long long width, void* stream) {
    constexpr int threads = DoubleShape::kThreads;
    unsigned int blocks = (unsigned int)((width + threads - 1) / threads);
    point_double_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        px, py, pz, ox, oy, oz, (uint32_t)width);
    return (int)cudaGetLastError();
}
