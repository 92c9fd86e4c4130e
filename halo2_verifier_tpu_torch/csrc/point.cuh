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

#include <type_traits>

#include "field.cuh"

namespace h2v {

// The masked add's body and launch shape for each limb format, chosen on
// the card by sweep_kernels.py point_add (PERF.md): the body, unrolled
// or rolled into loops over the coordinates (add_rolled), and block size
// x minimum blocks per SM, which caps registers at 65,536 / (threads x
// blocks). On an NVIDIA H100 80GB HBM3 at 700.00 W: the 16-bit format
// runs fastest unrolled, at 256 x 2 (128 registers, 16 warps per SM);
// the 8-bit format's unrolled code (9k SASS instructions, 143 KB) runs at
// 0.60 ms on the scan's widest launch and its rolled code (4.4k) at 0.35,
// best with no register cap (191 registers, 8 warps per SM).
template <class L>
struct AddShape;
template <>
struct AddShape<Limbs16> {
    static constexpr int kThreads = 256;
    static constexpr int kMinBlocks = 2;
    static constexpr bool kRolled = false;
};
template <>
struct AddShape<Limbs8> {
    static constexpr int kThreads = 256;
    static constexpr int kMinBlocks = 1;
    static constexpr bool kRolled = true;
};

// The 16-bit add's narrow shape (narrow::point_add_kernel): a launch of
// fewer than kBelow add lanes gives each output lane a group of kGroup
// threads of one warp (8 or 4), in blocks of kBlock threads. Chosen on
// the card by sweep_kernels.py point_add at the chain's narrow widths
// (PERF.md; NVIDIA H100 80GB HBM3 at 700.00 W, device time per launch):
// 8 threads a lane in blocks of 64 take 4.3 us at 64 lanes, 6.1 at 4,096
// and 16.4 at 16,384, where the wide shape takes 12.8, 17.4 and 17.9; 4
// threads a lane (two products each a layer) run 6.3-7.7 us up to 4,096
// lanes and within 1.2 us of 8 above; at 20,480 lanes the wide shape,
// which issues ~2.5x fewer instructions a lane, is ahead (18.3 against
// 19.8 us), so launches from 18,432 lanes take it.
struct NarrowShape {
    static constexpr int kGroup = 8;
    static constexpr int kBlock = 64;
    static constexpr int kBelow = 18432;
};

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

// RCB15 algorithm 7 on (X1:Y1:Z1) + (X2:Y2:Z2), stored to o[0], o[1],
// o[2] (rows w apart), in the reference's operation order.
template <class L>
__device__ __forceinline__ void add_unrolled(const Fe& X1, const Fe& Y1,
                                             const Fe& Z1, const Fe& X2,
                                             const Fe& Y2, const Fe& Z2,
                                             typename L::T* const (&o)[3],
                                             uint32_t w) {
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
    L::store(o[0], w, fq_sub(fq_mul(t3, t1m), fq_mul(t4, y3b)));
    L::store(o[1], w, fq_add(fq_mul(y3b, x3), fq_mul(t1m, z3)));
    L::store(o[2], w, fq_add(fq_mul(z3, t4), fq_mul(x3, t3)));
}

// The same values with 4 inlined Montgomery products instead of 12: the
// formulas are cyclic in the coordinates, so two loops over rotating
// triples compute them (rotation is register moves). Operands swap sides
// in two products and one sum; both commute bit for bit on canonical
// residues.
template <class L>
__device__ __forceinline__ void add_rolled(Fe u0, Fe u1, Fe u2, Fe v0,
                                           Fe v1, Fe v2,
                                           typename L::T* const (&o)[3],
                                           uint32_t w) {
    // iteration k: t_k = u_k v_k, s_k = (u_k + u_{k+1})(v_k + v_{k+1}),
    // shifted through (T0, T1, T2) and (S0, S1, S2)
    Fe T0 = {}, T1 = {}, T2 = {}, S0 = {}, S1 = {}, S2 = {};
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
        Fe t = fq_mul(u0, v0);
        Fe sk = fq_mul(fq_add(u0, u1), fq_add(v0, v1));
        Fe x = u0;
        u0 = u1;
        u1 = u2;
        u2 = x;
        x = v0;
        v0 = v1;
        v1 = v2;
        v2 = x;
        T0 = T1;
        T1 = T2;
        T2 = t;
        S0 = S1;
        S1 = S2;
        S2 = sk;
    }
    Fe t3 = fq_sub(S0, fq_add(T0, T1));
    Fe t4 = fq_sub(S1, fq_add(T1, T2));
    Fe y3 = fq_sub(S2, fq_add(T0, T2));
    Fe t2b = fq_mul_b3(T2);
    Fe x3 = fq_add(fq_add(T0, T0), T0);
    Fe z3 = fq_add(T1, t2b);
    Fe t1m = fq_sub(T1, t2b);
    Fe y3b = fq_mul_b3(y3);
    // out_k = a_k b_k -/+ b_{k+2} a_{k+1} (indices mod 3) for a = (t3, y3b,
    // z3), b = (t1m, x3, t4): X3 = t3 t1m - t4 y3b, Y3 = y3b x3 + t1m z3,
    // Z3 = z3 t4 + x3 t3
    Fe a0 = t3, a1 = y3b, a2 = z3, b0 = t1m, b1 = x3, b2 = t4;
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
        Fe p1 = fq_mul(a0, b0);
        Fe p2 = fq_mul(b2, a1);
        // a select, not o[k]: a dynamic index would put o in local memory
        L::store(k == 0 ? o[0] : k == 1 ? o[1] : o[2], w,
                 k == 0 ? fq_sub(p1, p2) : fq_add(p1, p2));
        Fe x = a0;
        a0 = a1;
        a1 = a2;
        a2 = x;
        x = b0;
        b0 = b1;
        b1 = b2;
        b2 = x;
    }
}

// Montgomery one (R mod q) as 32-bit words: the projective identity's Y.
__constant__ uint32_t MONT_ONE_FQ[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};

// A launch's scatter lanes (n of them, after the width output lanes):
// lane j copies the point p[:, pos[j]] to g[:, key[j]] (rows wg apart),
// its Y set to R where Y = Z = 0, the empty-bucket patch (plain version
// ops/msm_forest.py scatter_part_plain). n = 0: no scatter lanes.
template <class L>
struct PartScatter {
    const int32_t* pos;
    const int32_t* key;
    typename L::T* gx;
    typename L::T* gy;
    typename L::T* gz;
    uint32_t n;
    uint32_t wg;
};

template <class L>
__device__ __forceinline__ void scatter_lane(const typename L::T* px,
                                             const typename L::T* py,
                                             const typename L::T* pz,
                                             uint32_t wp,
                                             const PartScatter<L>& sc,
                                             uint32_t j) {
    uint32_t s = (uint32_t)sc.pos[j];
    uint32_t k = (uint32_t)sc.key[j];
    Fe X = L::load(px + s, wp);
    Fe Y = L::load(py + s, wp);
    Fe Z = L::load(pz + s, wp);
    uint32_t nz = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) nz |= Y.w[w] | Z.w[w];
    if (!nz) {
#pragma unroll
        for (int w = 0; w < 8; ++w) Y.w[w] = MONT_ONE_FQ[w];
    }
    L::store(sc.gx + k, sc.wg, X);
    L::store(sc.gy + k, sc.wg, Y);
    L::store(sc.gz + k, sc.wg, Z);
}

// out[i] = mask[i] ? P[i] + Q[i] : P[i], P[i] = p[:, il[i]] (or p[:, i]),
// Q[i] = q[:, ir[i]] (or q[:, i]); one thread per output lane, every
// intermediate in registers. A masked-out lane never reads Q. Lanes past
// the width are the scatter lanes of sc, which read p. L is the limb
// format (Limbs16 or Limbs8). Widths and indices are 32-bit: every
// tensor has fewer than 2^31 elements (ops/kernels.py checks).
template <class L>
__global__ void __launch_bounds__(AddShape<L>::kThreads,
                                  AddShape<L>::kMinBlocks)
point_add_kernel(const typename L::T* __restrict__ px,
                 const typename L::T* __restrict__ py,
                 const typename L::T* __restrict__ pz, uint32_t wp,
                 const typename L::T* __restrict__ qx,
                 const typename L::T* __restrict__ qy,
                 const typename L::T* __restrict__ qz, uint32_t wq,
                 const int32_t* __restrict__ il,
                 const int32_t* __restrict__ ir,
                 const uint8_t* __restrict__ mask,
                 typename L::T* __restrict__ ox,
                 typename L::T* __restrict__ oy,
                 typename L::T* __restrict__ oz, uint32_t width,
                 const PartScatter<L> sc) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) {
        if (i - width < sc.n) scatter_lane<L>(px, py, pz, wp, sc, i - width);
        return;
    }
    uint32_t l = il ? (uint32_t)il[i] : i;
    Fe X1 = L::load(px + l, wp);
    Fe Y1 = L::load(py + l, wp);
    Fe Z1 = L::load(pz + l, wp);
    typename L::T* const o[3] = {ox + i, oy + i, oz + i};
    if (mask && !mask[i]) {
        L::store(o[0], width, X1);
        L::store(o[1], width, Y1);
        L::store(o[2], width, Z1);
        return;
    }
    uint32_t r = ir ? (uint32_t)ir[i] : i;
    Fe X2 = L::load(qx + r, wq);
    Fe Y2 = L::load(qy + r, wq);
    Fe Z2 = L::load(qz + r, wq);
    if constexpr (AddShape<L>::kRolled)
        add_rolled<L>(X1, Y1, Z1, X2, Y2, Z2, o, width);
    else
        add_unrolled<L>(X1, Y1, Z1, X2, Y2, Z2, o, width);
}

namespace narrow {

__device__ __forceinline__ Fe shfl(const Fe& a, int src, int width) {
    Fe r;
#pragma unroll
    for (int w = 0; w < 8; ++w)
        r.w[w] = __shfl_sync(0xffffffffu, a.w[w], src, width);
    return r;
}

// e_k for k in 0..5, by selects (a dynamic index would put e in local
// memory)
__device__ __forceinline__ Fe pick(int k, const Fe& e0, const Fe& e1,
                                   const Fe& e2, const Fe& e3, const Fe& e4,
                                   const Fe& e5) {
    Fe r;
#pragma unroll
    for (int w = 0; w < 8; ++w)
        r.w[w] = k == 0   ? e0.w[w]
                 : k == 1 ? e1.w[w]
                 : k == 2 ? e2.w[w]
                 : k == 3 ? e3.w[w]
                 : k == 4 ? e4.w[w]
                          : e5.w[w];
    return r;
}

template <class T>
__device__ __forceinline__ T* coord(int c, T* x, T* y, T* z) {
    return c == 0 ? x : c == 1 ? y : z;
}

// point_add_kernel's function in the narrow shape: a group of G =
// NarrowShape::kGroup threads of one warp computes output lane i, the
// formula's two layers of 6 independent Montgomery products spread over
// it (R = 6 / G rounded up products per thread and layer; threads past
// product 5 compute a copy that nothing reads):
// - layer 1, product k of X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2),
//   (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2): coordinates f and g of each side,
//   loaded by the thread itself, summed (a + 0 = a where f = g);
// - every thread gathers the six by warp shuffles and forms t3, t4,
//   y3b, x3, z3, t1m itself (18 modular adds cost less than another
//   exchange);
// - layer 2, product k of t3 t1m, t4 y3b, y3b x3, t1m z3, z3 t4, x3 t3;
// - thread c < 3 gathers products 2c and 2c + 1 and stores coordinate c
//   of the sum: X3 = p0 - p1, Y3 = p2 + p3, Z3 = p4 + p5.
// Every product and sum is add_unrolled's on the same canonical operands,
// so outputs are bit-equal to the wide kernel's. Every thread of an add
// block reaches every shuffle (lanes past the width compute on zeros and
// store nothing); a masked-out lane reads no Q and stores P. Blocks past
// the add lanes' hold the scatter lanes, one thread each.
template <class L>
__global__ void __launch_bounds__(NarrowShape::kBlock)
point_add_kernel(const typename L::T* __restrict__ px,
                 const typename L::T* __restrict__ py,
                 const typename L::T* __restrict__ pz, uint32_t wp,
                 const typename L::T* __restrict__ qx,
                 const typename L::T* __restrict__ qy,
                 const typename L::T* __restrict__ qz, uint32_t wq,
                 const int32_t* __restrict__ il,
                 const int32_t* __restrict__ ir,
                 const uint8_t* __restrict__ mask,
                 typename L::T* __restrict__ ox,
                 typename L::T* __restrict__ oy,
                 typename L::T* __restrict__ oz, uint32_t width,
                 const PartScatter<L> sc) {
    constexpr int G = NarrowShape::kGroup;
    constexpr int B = NarrowShape::kBlock;
    constexpr int R = (6 + G - 1) / G;
    const uint32_t add_blocks = (width * G + B - 1) / B;
    if (blockIdx.x >= add_blocks) {
        uint32_t s = (blockIdx.x - add_blocks) * B + threadIdx.x;
        if (s < sc.n) scatter_lane<L>(px, py, pz, wp, sc, s);
        return;
    }
    uint32_t t = blockIdx.x * B + threadIdx.x;
    uint32_t i = t / G;
    int j = (int)(t % G);
    bool lane = i < width;
    bool adds = lane && (!mask || mask[i]);
    uint32_t l = lane ? (il ? (uint32_t)il[i] : i) : 0;
    uint32_t r = adds ? (ir ? (uint32_t)ir[i] : i) : 0;
    Fe res[R];
    Fe own = {};
#pragma unroll
    for (int q = 0; q < R; ++q) {
        int k = j + q * G;
        k = k < 6 ? k : k - 6;
        int f = k < 3 ? k : (k == 4 ? 1 : 0);
        int g = k < 3 ? k : (k == 3 ? 1 : 2);
        Fe a = {}, a2 = {}, b = {}, b2 = {};
        if (lane) a = L::load(coord(f, px, py, pz) + l, wp);
        if (lane && f != g) a2 = L::load(coord(g, px, py, pz) + l, wp);
        if (adds) b = L::load(coord(f, qx, qy, qz) + r, wq);
        if (adds && f != g) b2 = L::load(coord(g, qx, qy, qz) + r, wq);
        if (q == 0) own = a;
        res[q] = fq_mul(fq_add(a, a2), fq_add(b, b2));
    }
    Fe v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = shfl(res[k / G], k % G, G);
    Fe t3 = fq_sub(v[3], fq_add(v[0], v[1]));
    Fe t4 = fq_sub(v[4], fq_add(v[1], v[2]));
    Fe y3 = fq_sub(v[5], fq_add(v[0], v[2]));
    Fe t2b = fq_mul_b3(v[2]);
    Fe x3 = fq_add(fq_add(v[0], v[0]), v[0]);
    Fe z3 = fq_add(v[1], t2b);
    Fe t1m = fq_sub(v[1], t2b);
    Fe y3b = fq_mul_b3(y3);
    Fe p[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
        int k = j + q * G;
        k = k < 6 ? k : k - 6;
        p[q] = fq_mul(pick(k, t3, t4, y3b, t1m, z3, x3),
                      pick(k, t1m, y3b, x3, z3, t4, t3));
    }
    int c = j < 3 ? j : 0;
    Fe e = {}, o = {};
#pragma unroll
    for (int q = 0; q < R; ++q) {
        Fe se = shfl(p[q], (2 * c) % G, G);
        Fe so = shfl(p[q], (2 * c + 1) % G, G);
        if ((2 * c) / G == q) e = se;
        if ((2 * c + 1) / G == q) o = so;
    }
    if (lane && j < 3)
        L::store(coord(c, ox, oy, oz) + i, width,
                 !adds ? own : c == 0 ? fq_sub(e, o) : fq_add(e, o));
}

}  // namespace narrow

// The point add's launch: a 16-bit-limb launch of fewer than
// NarrowShape::kBelow add lanes in the narrow shape, every other launch
// in AddShape<L>'s.
template <class L>
int launch_point_add(const typename L::T* px, const typename L::T* py,
                     const typename L::T* pz, long long wp,
                     const typename L::T* qx, const typename L::T* qy,
                     const typename L::T* qz, long long wq,
                     const int32_t* il, const int32_t* ir,
                     const uint8_t* mask, typename L::T* ox,
                     typename L::T* oy, typename L::T* oz, long long width,
                     void* stream, const PartScatter<L>& sc = {}) {
    if constexpr (std::is_same<L, Limbs16>::value) {
        if (width < NarrowShape::kBelow) {
            constexpr long long B = NarrowShape::kBlock;
            long long blocks = (width * NarrowShape::kGroup + B - 1) / B +
                               (sc.n + B - 1) / B;
            narrow::point_add_kernel<L>
                <<<(unsigned int)blocks, (unsigned int)B, 0,
                   (cudaStream_t)stream>>>(
                    px, py, pz, (uint32_t)wp, qx, qy, qz, (uint32_t)wq, il,
                    ir, mask, ox, oy, oz, (uint32_t)width, sc);
            return (int)cudaGetLastError();
        }
    }
    constexpr int threads = AddShape<L>::kThreads;
    long long lanes = width + sc.n;
    unsigned int blocks = (unsigned int)((lanes + threads - 1) / threads);
    point_add_kernel<L><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        px, py, pz, (uint32_t)wp, qx, qy, qz, (uint32_t)wq, il, ir, mask, ox,
        oy, oz, (uint32_t)width, sc);
    return (int)cudaGetLastError();
}

}  // namespace h2v
