// The device pairing's tower kernels (ops/pairing.py).
//
// The reference (halo2_verifier_tpu/ops/pairing_jax.py) has no Pallas
// kernel here: its tower is one jitted XLA program, fused by XLA, whose
// widths (54 lanes per pair) never reach the Pallas K1. Eager PyTorch
// launches every tensor op on its own, so the pieces that would otherwise
// cost hundreds of small launches each are one launch each:
// - T1 fq_addsub: elementwise Fq add, subtract or negate (pairing_jax
//   `_fadd`/`_fsub`/`_fneg`, `lmfield.add`/`sub`/`neg`); plain versions
//   ops/field.py add_body, sub_body, neg_body;
// - fq12_mul: the whole Fq12 multiply of pairing_jax `fq12_mul` (its two
//   operand maps MA and MB, the 54 Montgomery products, the recombination
//   map MC) in one launch; plain version ops/pairing.py fq12_mul_plain;
// - T3 fq_inv: the Fermat inversion of pairing_jax `_finv`
//   (`lmfield.inv_mont`, a lax.scan of Montgomery products); plain
//   version ops/field.py inv_mont_body;
// - miller_step: one affine Miller step, the whole of pairing_jax
//   `_line_double` (mode 0) or `_line_add` (mode 1) with its line written
//   as a (16, 12, B) coefficient stack; plain version ops/pairing.py
//   miller_step_plain.
// Every output is the canonical residue, unique, so each kernel equals its
// plain version bit for bit whatever its internal representation.
//
// What bounds them (chip_smoke.py's model, which counts the function):
// T1 moves 64 B per operand and result for a few operations, so it is
// bound by bytes at any width that fills the card; fq12_mul
// does 54 products per lane on 36 elements moved, bound by its
// multiply-adds; T3 by the multiply-adds of the shortest fixed-window
// chain for N - 2, and the Miller step by those of that chain and its ~19
// products around it. The pairing runs them at 1-108 lanes, where a launch
// costs its latency: the fixed cost of a launch, and for fq12_mul, T3 and
// the step the chain of dependent steps inside one lane. The measured
// times and shares are in PERF.md.
//
// Design:
// - T1: one thread per lane on field.cuh's canonical add and sub; each
//   operand at its own row stride, so the column slices the tower hands
//   it (views into a wider product) need no copy.
// - fq12_mul: a block of Fq12Shape::kLanes lanes x 64 threads. The 24
//   coefficients of each lane are loaded into shared memory, lanes
//   fastest (coalesced at any width from 8 lanes a block); thread p of a
//   lane sums operand row p of MA and of MB (linmap.cuh, every nonzero of
//   MA and MB is 1), reduces both and takes their Montgomery product
//   (field.cuh mont_mul) into shared memory; then Fq12Shape::kSplit
//   neighbouring threads share each of the 12 outputs of MC, each summing
//   a run of the output's nonzeros into signed columns, combined by warp
//   shuffles and reduced once. The maps' nonzeros are constant tables
//   below, copied into shared memory (divergent reads of constant memory
//   serialize). Nothing but the operands and the result touches device
//   memory: one launch where the composition took four (a linear map for
//   MA, one for MB, a 54-lane K1, one for MC) and two stacks.
// - T3: one thread per lane on the radix-2^29 chain of mont29.cuh (64-bit
//   column sums, lazy reduction, a dedicated squaring), by a fixed window
//   of InvShape::kWindow bits over N - 2 (3 bits: 253 squarings and 71
//   products, where the bit-by-bit ladder ran 253 and 109), converting
//   into the internal radix R' = 2^261 and back with one product each so
//   that input and output stay 16-bit-limb Montgomery (R = 2^256)
//   residues; inv(0) = 0 falls out of it. At the pairing's 1-3 lanes a
//   launch is one warp's chain of 326 dependent products.
// - miller_step: one thread per lane runs the step from its inputs to its
//   stores, so the Miller loop launches one kernel per step where the
//   composition launched ~47 (T1's adds, K1's products, T3) and ~20 torch
//   ops. At the pairing's 1-2 lanes the step is one warp's latency: T3's
//   chain, inline (the same inv29 as fq_inv), with ~19 products and ~40
//   adds of field.cuh around it, so it costs about one T3 launch. The
//   formulas differ from the reference's composition where that saves
//   work (lambda = num conj(den) / norm(den) with one inverse; (px, 0)
//   times lambda as two products; squares of two products), which changes
//   no canonical output; den = 0 gives lambda = 0 as the reference's
//   inv(0) = 0 does. T and Q are read again after the chain, so only
//   num conj(den) lives across it. The mode is a template parameter, one
//   instantiation each (MillerShape::kModeTemplate; false reads it at run
//   time, for the sweep).
// The shapes were chosen on the card by sweep_kernels.py fq12_mul, fq_inv
// and miller_step; the numbers are in PERF.md.

#include <cuda_runtime.h>

#include "field.cuh"
#include "linmap.cuh"
#include "mont29.cuh"

// N - 2 for Fq and Fr as 32-bit words: the Fermat exponents.
static __constant__ uint32_t INV_EXP[2][8] = {
    {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xefffffffu, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
};

// 2^266 and 2^256 mod N in radix 2^29, Fq then Fr: a product by the first
// takes x 2^256 to x 2^261 (mont29.cuh's radix), by the second back.
static __constant__ uint32_t INV_IN29[2][9] = {
    {0x13349ca1u, 0x1a5d84a8u, 0x0a3e5cacu, 0x100249e0u, 0x12b951e8u,
     0x0e92d304u, 0x14cb95b3u, 0x041b9d3du, 0x00058003u},
    {0x0fffead7u, 0x1d5444f4u, 0x04438aa5u, 0x03b4d096u, 0x134c84dau,
     0x0e92d304u, 0x14cb95b3u, 0x041b9d3du, 0x00058003u},
};
static __constant__ uint32_t INV_OUT29[2][9] = {
    {0x058f0d9du, 0x1aea1c6eu, 0x11c2cf74u, 0x11d651ebu, 0x1462c0a7u,
     0x11b7bc3cu, 0x1cbd99bau, 0x183340fbu, 0x000e0a77u},
    {0x0ffffffbu, 0x04b1a0e2u, 0x18334a6bu, 0x18ed2b3eu, 0x1462e36fu,
     0x11b7bc3cu, 0x1cbd99bau, 0x183340fbu, 0x000e0a77u},
};

// The Fq12 multiply's maps (ops/pairing.py _derive_fq12_mul_maps) by
// their nonzeros, row by row: row r's run is [*_ROW[r], *_ROW[r + 1]) of
// *_COL (the input's index) and, for MC, *_COEF (its coefficient). MA and
// MB are one map, FQ12_MAB (the operands' preparation is symmetric), all
// of whose nonzeros are 1. Each table is padded to whole 32-bit words for
// the copy into shared memory.
static __constant__ __align__(4) uint8_t FQ12_MAB_ROW[56] = {
    0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 14, 16, 20, 22, 24, 28,
    30, 32, 36, 37, 38, 40, 41, 42, 44, 45, 46, 48, 50, 52, 56, 58,
    60, 64, 66, 68, 72, 74, 76, 80, 82, 84, 88, 90, 92, 96, 100, 104,
    112, 116, 120, 128, 132, 136, 144, 0,
};
static __constant__ __align__(4) uint8_t FQ12_MAB_COL[144] = {
    0, 1, 0, 1, 2, 3, 2, 3, 4, 5, 4, 5, 2, 4, 3, 5,
    2, 3, 4, 5, 0, 2, 1, 3, 0, 1, 2, 3, 0, 4, 1, 5,
    0, 1, 4, 5, 6, 7, 6, 7, 8, 9, 8, 9, 10, 11, 10, 11,
    8, 10, 9, 11, 8, 9, 10, 11, 6, 8, 7, 9, 6, 7, 8, 9,
    6, 10, 7, 11, 6, 7, 10, 11, 0, 6, 1, 7, 0, 1, 6, 7,
    2, 8, 3, 9, 2, 3, 8, 9, 4, 10, 5, 11, 4, 5, 10, 11,
    2, 4, 8, 10, 3, 5, 9, 11, 2, 3, 4, 5, 8, 9, 10, 11,
    0, 2, 6, 8, 1, 3, 7, 9, 0, 1, 2, 3, 6, 7, 8, 9,
    0, 4, 6, 10, 1, 5, 7, 11, 0, 1, 4, 5, 6, 7, 10, 11,
};
static __constant__ __align__(4) uint16_t FQ12_MC_ROW[14] = {
    0, 23, 47, 67, 91, 108, 132, 165, 201, 228, 264, 288, 324, 0,
};
static __constant__ __align__(4) uint8_t FQ12_MC_COL[324] = {
    0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 33, 34, 35, 0, 1, 2, 3, 4, 5, 6, 7, 8,
    9, 10, 11, 18, 19, 20, 21, 22, 23, 24, 25, 26, 33, 34, 35, 0,
    1, 3, 4, 6, 7, 8, 12, 13, 18, 19, 21, 22, 23, 24, 25, 26,
    27, 28, 29, 0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 0, 1, 3, 4, 6,
    7, 15, 16, 18, 19, 21, 22, 24, 25, 26, 30, 31, 0, 1, 2, 3,
    4, 5, 6, 7, 8, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 30, 31, 32, 0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 18,
    19, 21, 22, 23, 24, 25, 26, 27, 28, 29, 36, 37, 39, 40, 41, 42,
    43, 44, 45, 46, 47, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
    11, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 0, 1, 3, 4, 6, 7, 8,
    12, 13, 18, 19, 21, 22, 24, 25, 26, 30, 31, 36, 37, 39, 40, 42,
    43, 44, 48, 49, 0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 30, 31, 32, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 48, 49, 50, 0, 1, 3, 4, 6, 7, 15, 16,
    18, 19, 21, 22, 24, 25, 33, 34, 36, 37, 39, 40, 42, 43, 51, 52,
    0, 1, 2, 3, 4, 5, 6, 7, 8, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43,
    44, 51, 52, 53,
};
static __constant__ __align__(4) int8_t FQ12_MC_COEF[324] = {
    1, -1, -10, 8, 1, -10, 8, 1, 10, -8, -1, -10, 8, 1, 10, -8,
    -1, -10, 8, 1, 10, -8, -1, -1, -1, 1, 8, 10, -9, 8, 10, -9,
    -8, -10, 9, 8, 10, -9, -8, -10, 9, 8, 10, -9, -8, -10, 9, -1,
    1, -1, 1, 10, -8, -1, 1, -1, 1, -1, -10, 8, 1, -10, 8, 1,
    10, -8, -1, 1, 1, -1, 1, 1, -1, -8, -10, 9, -1, -1, 1, -1,
    -1, 1, 8, 10, -9, 8, 10, -9, -8, -10, 9, -1, 1, 1, -1, -1,
    1, 1, -1, -1, 1, -1, 1, 10, -8, -1, 1, -1, 1, 1, -1, -1,
    -1, 1, 1, 1, -1, -1, -1, 1, 1, 1, -1, 1, 1, -1, -8, -10,
    9, -1, -1, 1, -1, 1, 10, -8, -1, 10, -8, -1, -10, 8, 1, -1,
    1, 10, -8, -1, 10, -8, -1, -10, 8, 1, 1, -1, -10, 8, 1, -10,
    8, 1, 10, -8, -1, 1, 1, -1, -8, -10, 9, -8, -10, 9, 8, 10,
    -9, 1, 1, -1, -8, -10, 9, -8, -10, 9, 8, 10, -9, -1, -1, 1,
    8, 10, -9, 8, 10, -9, -8, -10, 9, 1, -1, 1, -1, -10, 8, 1,
    -1, 1, 1, -1, 1, -1, -10, 8, 1, -1, 1, -1, 1, -1, 1, 10,
    -8, -1, 1, -1, -1, -1, 1, -1, -1, 1, 8, 10, -9, 1, 1, -1,
    -1, -1, 1, -1, -1, 1, 8, 10, -9, 1, 1, -1, 1, 1, -1, 1,
    1, -1, -8, -10, 9, -1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 1,
    1, -1, -1, 1, 1, -1, -1, 1, -1, 1, 1, -1, -1, 1, 1, -1,
    -1, -1, 1, 1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, 1, 1,
    1, -1, -1, -1, 1, 1, 1, -1, 1, 1, -1, -1, -1, 1, 1, 1,
    -1, -1, -1, 1,
};

namespace {

constexpr int kThreads = 256;  // T1's blocks
constexpr int kInvBits = 254;  // bit length of N - 2, both moduli
constexpr int kCoefs = 12;     // an Fq12 element's Fq coefficients
constexpr int kProducts = 54;  // the Fq12 multiply's Fq products
constexpr int kRoles = 64;     // threads per lane of fq12_mul

// fq12_mul's lanes per block, and threads per output of MC (a power of
// two, at most 4: 12 x kSplit threads of a lane's 64).
struct Fq12Shape {
    static constexpr int kLanes = 2;
    static constexpr int kSplit = 4;
};

// T3's block size and exponent window.
struct InvShape {
    static constexpr int kInvThreads = 64;
    static constexpr int kWindow = 3;
};

// The Miller step's block size, and whether its mode is a template
// parameter (one instantiation per mode) or an argument read at run time.
struct MillerShape {
    static constexpr int kStepThreads = 64;
    static constexpr bool kModeTemplate = true;
};

// The Miller step's line in ops/pairing.py _fq12_coeff_stack's order: py
// in slot kLinePy, c3 in kLineC3 and kLineC3 + 1, c4 in kLineC4 and
// kLineC4 + 1, zeros in the other 7.
constexpr int kLinePy = 0, kLineC3 = 6, kLineC4 = 8;
constexpr int kRuntimeMode = -1;  // miller_step_kernel reads `mode`

using h2v::E29;
using h2v::Fe;
using h2v::Limbs16;

enum Op { kAdd = 0, kSub = 1, kNeg = 2 };

__global__ void __launch_bounds__(kThreads)
fq_addsub_kernel(const int32_t* __restrict__ a, uint32_t a_stride,
                 const int32_t* __restrict__ b, uint32_t b_stride,
                 int32_t* __restrict__ out, uint32_t width, int op) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    Fe x = Limbs16::load(a + i, a_stride);
    Fe r;
    if (op == kNeg) {
        Fe zero{};
        r = h2v::sub<0>(zero, x);
    } else {
        Fe y = Limbs16::load(b + i, b_stride);
        r = op == kAdd ? h2v::add<0>(x, y) : h2v::sub<0>(x, y);
    }
    Limbs16::store(out + i, width, r);
}

__device__ __forceinline__ void load_words(uint32_t (&w)[8],
                                           const uint32_t* p) {
    const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
    const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

// Copy a constant table of N bytes (a multiple of 4) into shared memory,
// one 32-bit word per thread and step.
template <int N>
__device__ __forceinline__ void copy_table(void* dst, const void* src) {
    static_assert(N % 4 == 0, "tables are padded to whole words");
    for (int k = threadIdx.x; k < N / 4; k += blockDim.x)
        static_cast<uint32_t*>(dst)[k] = static_cast<const uint32_t*>(src)[k];
}

__device__ __forceinline__ void store_words(uint32_t* p, const Fe& v) {
    reinterpret_cast<uint4*>(p)[0] =
        make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
    reinterpret_cast<uint4*>(p)[1] =
        make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// Operand row r of MA (or MB) over one lane's 12 coefficients x: the sum
// of at most 8 canonical elements, reduced.
__device__ __forceinline__ Fe mab_row(const uint8_t* row, const uint8_t* col,
                                      const uint32_t (*x)[8], int r) {
    int64_t s[8] = {};
#pragma unroll 1
    for (int k = row[r]; k < row[r + 1]; ++k) {
        uint32_t v[8];
        load_words(v, x[col[k]]);
        h2v::lin_mac(s, 1, v);
    }
    return h2v::lin_reduce<0>(s);
}

// a, b, out: (16, 12, width) int32 canonical Montgomery coefficient
// stacks (limb, coefficient, lane); out = a * b in Fq12.
template <int L, int S>
__global__ void __launch_bounds__(L * kRoles)
fq12_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, uint32_t width) {
    static_assert(S == 1 || S == 2 || S == 4, "kSplit is 1, 2 or 4");
    // a's coefficients, then b's, as words; the outputs after the products
    __shared__ __align__(16) uint32_t s_x[L][2 * kCoefs][8];
    __shared__ __align__(16) uint32_t s_p[L][kProducts][8];
    __shared__ __align__(4) uint8_t s_mab_row[sizeof(FQ12_MAB_ROW)];
    __shared__ __align__(4) uint8_t s_mab_col[sizeof(FQ12_MAB_COL)];
    __shared__ __align__(4) uint16_t s_mc_row[14];
    __shared__ __align__(4) uint8_t s_mc_col[sizeof(FQ12_MC_COL)];
    __shared__ __align__(4) int8_t s_mc_coef[sizeof(FQ12_MC_COEF)];

    const uint32_t lane0 = blockIdx.x * L;
    const uint32_t lanes = min((uint32_t)L, width - lane0);
    const uint32_t plane = kCoefs * width;  // one limb row of a stack

    // 1. coefficients into shared memory, lanes fastest, without a branch
    // (a lane past the end reads the last one) and with every step's loads
    // in flight at once; the map tables
    static_assert(2 * kCoefs * 8 % kRoles == 0, "whole steps");
#pragma unroll
    for (int step = 0; step < 2 * kCoefs * 8 / kRoles; ++step) {
        const uint32_t e = threadIdx.x + step * L * kRoles;
        const uint32_t l = e % L, r = e / L, j = r & 7, c = r >> 3;
        const int32_t* src = (c < kCoefs ? a : b) + (c % kCoefs) * width +
                             lane0 + min(l, lanes - 1);
        s_x[l][c][j] = __byte_perm((uint32_t)src[(2 * j) * plane],
                                   (uint32_t)src[(2 * j + 1) * plane],
                                   0x5410);
    }
    copy_table<sizeof(FQ12_MAB_ROW)>(s_mab_row, FQ12_MAB_ROW);
    copy_table<sizeof(FQ12_MAB_COL)>(s_mab_col, FQ12_MAB_COL);
    copy_table<sizeof(FQ12_MC_ROW)>(s_mc_row, FQ12_MC_ROW);
    copy_table<sizeof(FQ12_MC_COL)>(s_mc_col, FQ12_MC_COL);
    copy_table<sizeof(FQ12_MC_COEF)>(s_mc_coef, FQ12_MC_COEF);
    __syncthreads();

    const uint32_t l = threadIdx.x / kRoles, role = threadIdx.x % kRoles;
    const bool live = l < lanes;

    // 2. operand row `role` of MA and of MB, and their product
    if (live && role < kProducts) {
        const Fe x = mab_row(s_mab_row, s_mab_col, s_x[l], role);
        const Fe y = mab_row(s_mab_row, s_mab_col, s_x[l] + kCoefs, role);
        store_words(s_p[l][role], h2v::mont_mul<0>(x, y));
    }
    __syncthreads();

    // 3. output o of MC: part `part` of its nonzeros into signed columns,
    // the S parts (neighbouring threads of one warp) combined by shuffles
    const uint32_t o = role / S, part = role % S;
    int64_t d[8] = {};
    if (live && o < kCoefs) {
        const int r0 = s_mc_row[o], n = s_mc_row[o + 1] - r0;
#pragma unroll 1
        for (int k = r0 + part * n / S; k < r0 + (part + 1) * n / S; ++k) {
            uint32_t v[8];
            load_words(v, s_p[l][s_mc_col[k]]);
            h2v::lin_mac(d, s_mc_coef[k], v);
        }
    }
#pragma unroll
    for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            d[j] += __shfl_down_sync(0xffffffffu, d[j], off);
    if (live && o < kCoefs && part == 0)
        store_words(s_x[l][o], h2v::lin_reduce<0>(d));
    __syncthreads();

    // 4. the 12 outputs to device memory, lanes fastest
    for (uint32_t e = threadIdx.x; e < kCoefs * 8 * L; e += L * kRoles) {
        const uint32_t l2 = e % L, r = e / L, j = r & 7, c = r >> 3;
        if (l2 >= lanes) continue;
        const uint32_t w = s_x[l2][c][j];
        int32_t* dst = out + c * width + lane0 + l2;
        dst[(2 * j) * plane] = (int32_t)(w & 0xFFFFu);
        dst[(2 * j + 1) * plane] = (int32_t)(w >> 16);
    }
}

// x R -> x^-1 R for a canonical x (R = 2^256; inv(0) = 0): T3's chain.
template <int F, int W>
__device__ __forceinline__ Fe inv29(const Fe& x) {
    // x 2^256 (canonical, exact limbs) -> x 2^261, below 2N
    E29 r[1] = {h2v::mul29<F>(h2v::from_words(x),
                              h2v::from_const29(INV_IN29[F]))};
    h2v::pow_window29<F, W, 1, kInvBits>(r, INV_EXP[F]);
    // x^-1 2^261 -> x^-1 2^256, below 2N: exact limbs, words, one
    // conditional subtract
    const E29 y = h2v::mul29<F>(r[0], h2v::from_const29(INV_OUT29[F]));
    return h2v::cond_sub<F>(h2v::to_words(h2v::normalize29(y)));
}

template <int F, int W>
__global__ void __launch_bounds__(InvShape::kInvThreads)
fq_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
              uint32_t width) {
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    Limbs16::store(out + i, width, inv29<F, W>(Limbs16::load(a + i, width)));
}

// r[k] = a[k] b[k] for k < N, one layer of the Miller step's independent
// products, one after another: a rolled loop of one product's code, so
// the step's registers stay one product's plus the live values (with
// every product inlined, the doubling took 254 registers and spilled;
// two or three products interleaved per turn ran slower on the card); the
// operands wait in local memory.
template <int N>
__device__ __forceinline__ void fq_mul_n(Fe (&r)[N], const Fe (&a)[N],
                                         const Fe (&b)[N]) {
#pragma unroll 1
    for (int k = 0; k < N; ++k) r[k] = h2v::mont_mul<0>(a[k], b[k]);
}

// Fq2 = Fq[u]/(u^2 + 1) on canonical Fq Montgomery residues.
struct Fq2 {
    Fe c0, c1;
};

__device__ __forceinline__ Fq2 fq2_add(const Fq2& a, const Fq2& b) {
    return {h2v::add<0>(a.c0, b.c0), h2v::add<0>(a.c1, b.c1)};
}

__device__ __forceinline__ Fq2 fq2_sub(const Fq2& a, const Fq2& b) {
    return {h2v::sub<0>(a.c0, b.c0), h2v::sub<0>(a.c1, b.c1)};
}

__device__ __forceinline__ Fe fq_neg(const Fe& a) {
    return h2v::sub<0>(Fe{}, a);
}

// a b by Karatsuba: 3 products.
__device__ __forceinline__ Fq2 fq2_mul(const Fq2& a, const Fq2& b) {
    const Fe x[3] = {a.c0, a.c1, h2v::add<0>(a.c0, a.c1)};
    const Fe y[3] = {b.c0, b.c1, h2v::add<0>(b.c0, b.c1)};
    Fe t[3];
    fq_mul_n(t, x, y);
    return {h2v::sub<0>(t[0], t[1]),
            h2v::sub<0>(h2v::sub<0>(t[2], t[0]), t[1])};
}

// (a0 s, a1 s): 2 products.
__device__ __forceinline__ Fq2 fq2_scale(const Fq2& a, const Fe& s) {
    const Fe x[2] = {a.c0, a.c1};
    const Fe y[2] = {s, s};
    Fe t[2];
    fq_mul_n(t, x, y);
    return {t[0], t[1]};
}

// Fq2 coefficient pair (c, c + 1) of lane i of a (16, 4, width) stack.
__device__ __forceinline__ Fq2 load_fq2(const int32_t* __restrict__ s, int c,
                                        uint32_t width, uint32_t i) {
    return {Limbs16::load(s + c * width + i, 4 * width),
            Limbs16::load(s + (c + 1) * width + i, 4 * width)};
}

__device__ __forceinline__ void store_fq2(int32_t* __restrict__ s, int c,
                                          uint32_t rows, uint32_t width,
                                          uint32_t i, const Fq2& v) {
    Limbs16::store(s + c * width + i, rows, v.c0);
    Limbs16::store(s + (c + 1) * width + i, rows, v.c1);
}

// One affine Miller step per lane: M = 0 doubles T (pairing_jax
// _line_double), M = 1 adds Q to T (_line_add), M = kRuntimeMode reads
// `mode`. t, q: (16, 4, width) stacks (xt0, xt1, yt0, yt1), q unread when
// doubling; px, py: (16, width) rows at their own strides; t_out: (16, 4,
// width), T'; line: (16, 12, width), the line at P.
template <int M>
__global__ void __launch_bounds__(MillerShape::kStepThreads)
miller_step_kernel(const int32_t* __restrict__ t,
                   const int32_t* __restrict__ q,
                   const int32_t* __restrict__ px, uint32_t px_stride,
                   const int32_t* __restrict__ py, uint32_t py_stride,
                   int32_t* __restrict__ t_out, int32_t* __restrict__ line,
                   uint32_t width, int mode) {
    const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    const bool add_q = (M == kRuntimeMode ? mode : M) != 0;
    // The products run in five layers of independent ones, as the
    // reference batches them: the norm (and, doubling, xt^2); num conj(den);
    // lambda; lambda^2, lambda xr and lambda px; lambda (xt - x3).
    // 1. lambda = num / den = num conj(den) / norm(den): doubling, num =
    // 3 xt^2 and den = 2 yt; adding, num = yt - yq and den = xt - xq.
    // The run-time mode takes the doubling's layer in both modes.
    constexpr int kPre = M == 1 ? 2 : 4;
    Fq2 num, den;
    Fe a1[kPre], b1[kPre], p1[kPre];
    if (add_q) {
        num = fq2_sub(load_fq2(t, 2, width, i), load_fq2(q, 2, width, i));
        den = fq2_sub(load_fq2(t, 0, width, i), load_fq2(q, 0, width, i));
    } else {
        const Fq2 yt = load_fq2(t, 2, width, i);
        den = fq2_add(yt, yt);
    }
    a1[0] = b1[0] = den.c0;
    a1[1] = b1[1] = den.c1;
    if constexpr (kPre == 4) {  // xt^2 = (x0 + x1)(x0 - x1) + 2 x0 x1 u
        const Fq2 xt = load_fq2(t, 0, width, i);
        a1[2] = h2v::add<0>(xt.c0, xt.c1);
        b1[2] = h2v::sub<0>(xt.c0, xt.c1);
        a1[3] = xt.c0;
        b1[3] = xt.c1;
    }
    fq_mul_n(p1, a1, b1);
    const Fe norm = h2v::add<0>(p1[0], p1[1]);
    if (!add_q) {
        const Fq2 s = {p1[kPre - 2], h2v::add<0>(p1[kPre - 1], p1[kPre - 1])};
        num = fq2_add(fq2_add(s, s), s);
    }
    const Fq2 w = fq2_mul(num, {den.c0, fq_neg(den.c1)});
    // 2. the norm's inverse, T3's chain (norm 0 -> 0, so lambda = 0)
    const Fe ninv = inv29<0, InvShape::kWindow>(norm);
    // 3. lambda, then lambda^2 = (l0 + l1)(l0 - l1) + 2 l0 l1 u, lambda xr
    // by Karatsuba (xr = xt doubling, xq adding) and lambda px; T and Q
    // read again, so that neither lives across the chain
    const Fq2 lam = fq2_scale(w, ninv);
    const Fq2 xt = load_fq2(t, 0, width, i), yt = load_fq2(t, 2, width, i);
    const Fq2 xr = add_q ? load_fq2(q, 0, width, i) : xt;
    const Fe p = Limbs16::load(px + i, px_stride);
    const Fe l01 = h2v::add<0>(lam.c0, lam.c1);
    const Fe a4[7] = {l01, lam.c0, lam.c0, lam.c1, l01, lam.c0, lam.c1};
    const Fe b4[7] = {h2v::sub<0>(lam.c0, lam.c1), lam.c1, xr.c0, xr.c1,
                      h2v::add<0>(xr.c0, xr.c1), p, p};
    Fe p4[7];
    fq_mul_n(p4, a4, b4);
    const Fq2 ll = {p4[0], h2v::add<0>(p4[1], p4[1])};
    const Fq2 lx = {h2v::sub<0>(p4[2], p4[3]),
                    h2v::sub<0>(h2v::sub<0>(p4[4], p4[2]), p4[3])};
    const Fq2 c3 = {fq_neg(p4[5]), fq_neg(p4[6])};
    // 4. x3, c4 = lambda xr - yr, y3 = lambda (xt - x3) - yt
    Fq2 x3, c4;
    if (add_q) {
        x3 = fq2_sub(fq2_sub(ll, xt), xr);
        c4 = fq2_sub(lx, load_fq2(q, 2, width, i));
    } else {
        x3 = fq2_sub(ll, fq2_add(xt, xt));
        c4 = fq2_sub(lx, yt);
    }
    const Fq2 y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt);
    // 5. T' and the line's 12 coefficients: py copied, zeros written
    const uint32_t t_rows = 4 * width, l_rows = kCoefs * width;
    store_fq2(t_out, 0, t_rows, width, i, x3);
    store_fq2(t_out, 2, t_rows, width, i, y3);
#pragma unroll
    for (int k = 0; k < 16; ++k)
        line[k * l_rows + kLinePy * width + i] = py[k * py_stride + i];
    store_fq2(line, kLineC3, l_rows, width, i, c3);
    store_fq2(line, kLineC4, l_rows, width, i, c4);
#pragma unroll
    for (int c = 0; c < kCoefs; ++c) {
        if (c == kLinePy || c == kLineC3 || c == kLineC3 + 1 ||
            c == kLineC4 || c == kLineC4 + 1)
            continue;
        Limbs16::store(line + c * width + i, l_rows, Fe{});
    }
}

unsigned int blocks_for(long long n, int threads) {
    return (unsigned int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int h2v_fq_addsub(const int32_t* a, long long a_stride,
                             const int32_t* b, long long b_stride,
                             int32_t* out, long long width, int op,
                             void* stream) {
    fq_addsub_kernel<<<blocks_for(width, kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(
        a, (uint32_t)a_stride, b, (uint32_t)b_stride, out, (uint32_t)width,
        op);
    return (int)cudaGetLastError();
}

extern "C" int h2v_fq12_mul(const int32_t* a, const int32_t* b,
                            int32_t* out, long long width, void* stream) {
    constexpr int L = Fq12Shape::kLanes;
    fq12_mul_kernel<L, Fq12Shape::kSplit>
        <<<blocks_for(width, L), L * kRoles, 0, (cudaStream_t)stream>>>(
            a, b, out, (uint32_t)width);
    return (int)cudaGetLastError();
}

extern "C" int h2v_fq_inv(const int32_t* a, int32_t* out, long long width,
                          int field, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    constexpr int T = InvShape::kInvThreads, W = InvShape::kWindow;
    if (field == 0)
        fq_inv_kernel<0, W><<<blocks_for(width, T), T, 0, s>>>(
            a, out, (uint32_t)width);
    else
        fq_inv_kernel<1, W><<<blocks_for(width, T), T, 0, s>>>(
            a, out, (uint32_t)width);
    return (int)cudaGetLastError();
}

namespace {

// A template, so that only the instantiations the shape asks for compile.
template <bool kModeTemplate>
void launch_miller_step(const int32_t* t, const int32_t* q,
                        const int32_t* px, uint32_t px_stride,
                        const int32_t* py, uint32_t py_stride,
                        int32_t* t_out, int32_t* line, uint32_t width,
                        int mode, cudaStream_t s) {
    constexpr int T = MillerShape::kStepThreads;
    const unsigned int blocks = blocks_for(width, T);
    if constexpr (!kModeTemplate)
        miller_step_kernel<kRuntimeMode><<<blocks, T, 0, s>>>(
            t, q, px, px_stride, py, py_stride, t_out, line, width, mode);
    else if (mode == 0)
        miller_step_kernel<0><<<blocks, T, 0, s>>>(
            t, q, px, px_stride, py, py_stride, t_out, line, width, mode);
    else
        miller_step_kernel<1><<<blocks, T, 0, s>>>(
            t, q, px, px_stride, py, py_stride, t_out, line, width, mode);
}

}  // namespace

extern "C" int h2v_miller_step(const int32_t* t, const int32_t* q,
                               const int32_t* px, long long px_stride,
                               const int32_t* py, long long py_stride,
                               int32_t* t_out, int32_t* line,
                               long long width, int mode, void* stream) {
    launch_miller_step<MillerShape::kModeTemplate>(
        t, q, px, (uint32_t)px_stride, py, (uint32_t)py_stride, t_out, line,
        (uint32_t)width, mode, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
