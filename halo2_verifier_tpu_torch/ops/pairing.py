"""Device BN254 pairing: the DualMSM::check final test (reference:
poly/kzg/msm.rs:185-203) on the card. Port of
halo2_verifier_tpu/ops/pairing_jax.py; every name there has its
counterpart here.

The tower arithmetic is LANE-PACKED as in the reference: the independent
Fq products of an Fq2/Fq6/Fq12 operation are concatenated along the lane
axis and issued as one wide Montgomery multiply (K1, `field.mont_mul`), so
an Fq12 multiply is one 54-lane product between two exact linear maps.
The Miller loops of all pairs run in parallel lanes (one lane per pair);
the lane product and the one final exponentiation run at width 1.

Eager PyTorch launches every tensor op on its own, where XLA fused the
reference's program into one, so the pieces that would otherwise cost
hundreds of small launches each have a kernel of their own
(csrc/tower.cu, through ops/kernels.py), used for CUDA tensors:
- T1 `fq_addsub`: the Fq add, subtract and negate of `_fadd`, `_fsub`,
  `_fneg` (plain versions: `field.add_body`, `sub_body`, `neg_body`);
- `fq12_mul`: the whole Fq12 multiply, its two operand maps, 54 products
  and recombination map in one launch, on (NLIMBS, 12, B) coefficient
  stacks (`fq12_mul_stack`; plain version: `fq12_mul_plain`, the
  reference's composition on the plain versions);
- T3 `fq_inv`: the Fermat inversion of `_finv`, through `field.inv_mont`
  (plain version: `field.inv_mont_body`);
- `miller_step`: one affine Miller step, the whole of `_line_double` or
  `_line_add` (their add chains, Fq2 products and inversion) in one
  launch, on (NLIMBS, 4, B) point stacks and writing the line as an
  (NLIMBS, 12, B) coefficient stack (`_miller_step`; plain version:
  `miller_step_plain`, the reference's composition on the plain bodies).
CPU tensors take the plain versions. Limbs are (NLIMBS, B) int32
canonical Montgomery residues at every function boundary, as in
ops/field.py. An Fq12 value that only multiplies stays a coefficient
stack: the Miller loop's accumulator and the hard part's exponentiation
stack once on entry and split into the reference's tuple tree on exit;
the Miller loop's point T stays a point stack from step to step.

`lax.scan` and `lax.cond` over the static bit arrays become Python loops
over the same bits; a zero exponent bit skips the product the reference
computes and then discards, which changes no output. Nothing in the tower
reads a device value on the host: `pairing_check_device` copies the one
final Fq12 to the host to compare it with Montgomery one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import field as fm
from . import hostpairing as hp
from . import kernels
from .constants import ATE_LOOP_COUNT, P, R
from .limbs import NLIMBS, int_to_limbs, ints_to_limbs, limbs_to_int

FQ = fm.FQ
I32 = torch.int32
I64 = torch.int64

# ------------------------------------------------------------ Fq helpers


def _fadd(a, b):
    if a.is_cuda:
        return kernels.fq_addsub(a, b, kernels.FQ_ADD)
    return fm.add(a, b, FQ)


def _fsub(a, b):
    if a.is_cuda:
        return kernels.fq_addsub(a, b, kernels.FQ_SUB)
    return fm.sub(a, b, FQ)


def _fneg(a):
    if a.is_cuda:
        return kernels.fq_addsub(a, None, kernels.FQ_NEG)
    return fm.neg(a, FQ)


def _finv(a):
    return fm.inv_mont(a, FQ)


def _zero(b, device):
    return torch.zeros((NLIMBS, b), dtype=I32, device=device)


def _one(b, device):
    return fm.mont_one(FQ, b, device)


def _mul_many(pairs):
    """THE lane-packing primitive: k independent Fq products as ONE wide
    Montgomery multiply. pairs: [(a, b)] of (NLIMBS, B) tensors; returns
    the k products."""
    if len(pairs) == 1:
        a, b = pairs[0]
        return [fm.mont_mul(a.contiguous(), b.contiguous(), FQ)]
    b = pairs[0][0].shape[1]
    A = torch.cat([a for a, _ in pairs], dim=1)
    Bm = torch.cat([bb for _, bb in pairs], dim=1)
    out = fm.mont_mul(A, Bm, FQ)
    return [out[:, i * b:(i + 1) * b] for i in range(len(pairs))]


def _x9(a):
    """9*a by add chain (Montgomery form is linear): 8a + a."""
    d1 = _fadd(a, a)
    d2 = _fadd(d1, d1)
    d3 = _fadd(d2, d2)
    return _fadd(d3, a)


def _x2(a):
    return _fadd(a, a)


def _x3(a):
    return _fadd(_fadd(a, a), a)


# ------------------------------------------------------------ Fq2 tower
# Fq2 = Fq[u]/(u^2+1); elements are (c0, c1) pairs of (NLIMBS, B) tensors.


def fq2_add(a, b):
    return (_fadd(a[0], b[0]), _fadd(a[1], b[1]))


def fq2_sub(a, b):
    return (_fsub(a[0], b[0]), _fsub(a[1], b[1]))


def fq2_neg(a):
    return (_fneg(a[0]), _fneg(a[1]))


def fq2_conj(a):
    return (a[0], _fneg(a[1]))


def _fq2_prod_terms(a, b):
    """The 3 independent Fq products of a Karatsuba Fq2 multiply."""
    return [(a[0], b[0]), (a[1], b[1]),
            (_fadd(a[0], a[1]), _fadd(b[0], b[1]))]


def _fq2_combine(t0, t1, t2):
    return (_fsub(t0, t1), _fsub(_fsub(t2, t0), t1))


def fq2_mul_many(ps):
    """k independent Fq2 products in ONE wide mont_mul (3k Fq lanes)."""
    flat = []
    for a, b in ps:
        flat.extend(_fq2_prod_terms(a, b))
    prod = _mul_many(flat)
    return [
        _fq2_combine(prod[3 * i], prod[3 * i + 1], prod[3 * i + 2])
        for i in range(len(ps))
    ]


def fq2_mul(a, b):
    return fq2_mul_many([(a, b)])[0]


def fq2_square(a):
    return fq2_mul(a, a)


def fq2_mul_xi(a):
    """xi = 9 + u: (9 a0 - a1, 9 a1 + a0) — add chains, no multiply."""
    return (_fsub(_x9(a[0]), a[1]), _fadd(_x9(a[1]), a[0]))


def fq2_inv(a):
    """conj(a) / (a0^2 + a1^2); inv(0) = 0 (as field.inv_mont)."""
    sq = _mul_many([(a[0], a[0]), (a[1], a[1])])
    ninv = _finv(_fadd(sq[0], sq[1]))
    out = _mul_many([(a[0], ninv), (a[1], ninv)])
    return (out[0], _fneg(out[1]))


def fq2_zero(b, device):
    return (_zero(b, device), _zero(b, device))


def fq2_one(b, device):
    return (_one(b, device), _zero(b, device))


# --------------------------------------------- batched linear combines
#
# The tower's multiply formulas are (operand prep) -> (independent Fq
# products) -> (recombination), where prep and recombination are LINEAR
# maps with small integer coefficients. On the card the Fq12 multiply
# runs its three maps inside its one fused launch; elsewhere each map is
# linear_combine_plain, the reference's linear combine
# (pairing_jax.py:245): two integer sums over the stacked 16-bit limbs
# (far below 2^32) and one batched exact mod-P reduction.


_GEOM16 = ((1 << 256) - 1) // ((1 << 16) - 1)  # sum(2^(16 i), i<16)


def _offset_limbs(min_limb: int):
    """A multiple K*P of the modulus as 17 limb rows with every LOW limb
    (rows 0..15) >= min_limb: base = min_limb on each low limb, the
    canonical remainder K*P - base stacked on top. Makes (pos + (off -
    neg)) borrow-free limb-wise for any neg with limbs < min_limb."""
    v0 = min_limb * _GEOM16
    K = v0 // P + 1
    rm = K * P - v0
    if not (0 < rm < (1 << 272)):
        raise ValueError("offset remainder out of range")
    limbs = np.asarray(
        [min_limb * (i < 16) + ((rm >> (16 * i)) & 0xFFFF)
         for i in range(17)],
        dtype=np.int64,
    )
    return limbs, K


# 2^256 mod P (the hi-limb fold constant) in 16-bit limbs
_C256 = int_to_limbs((1 << 256) % P).astype(np.int64)
# conditional-subtract constants: value < 6P -> canonical via 4P, 2P, P
_COND_SUB_LIMBS = [
    np.asarray([((j * P) >> (16 * i)) & 0xFFFF for i in range(17)],
               dtype=np.int64)
    for j in (4, 2, 1)
]


def _rows(limbs_np, ndim, device):
    """A constant limb column shaped to broadcast over (rows, ...)."""
    return torch.from_numpy(np.asarray(limbs_np, dtype=np.int64)).reshape(
        (-1,) + (1,) * (ndim - 1)).to(device)


def _reduce_mod_p(acc):
    """(17, k, B) int64 redundant limbs (value < ~2^12 * P, limbs < 2^24)
    -> (NLIMBS, k, B) canonical residues. One carry + three hi-limb folds
    + a 4P/2P/P conditional-subtract chain, batched over k x B."""
    x = fm.carry_prop(fm._with_overflow_row(acc))  # 18 canonical rows
    # fold limbs >= 16 back via 2^256 === _C256 (mod P); 3 rounds bring
    # any value < 2^12 P under 6P (each round: < 2^256 + hi*0.43P)
    c = _rows(_C256, acc.ndim, acc.device)
    for _ in range(3):
        lo = x[:NLIMBS]
        hi = x[NLIMBS:]
        hiv = hi[0]
        if hi.shape[0] > 1:
            hiv = hiv + (hi[1] << 16)
        # rows beyond 17 are structurally zero (value bounds above)
        folded = lo + hiv[None] * c
        x = fm.carry_prop(fm._with_overflow_row(folded))  # 17 rows
    # now < 6P over 17 limbs: conditionally subtract 4P, 2P, P
    # (complement-add; the overflow row is the >= predicate, as
    # field.cond_sub_n)
    for limbs_np in _COND_SUB_LIMBS:
        comp = [0xFFFF - int(limbs_np[i]) + (i == 0) for i in range(17)]
        t = fm.carry_prop(fm._with_overflow_row(
            x + _rows(comp, acc.ndim, acc.device)))
        ge = t[17] > 0
        x = torch.where(ge[None], t[:17], x)
    return x[:NLIMBS]


def _map_bound(M):
    """The largest sum of |coefficients| in a row of M, checked against
    the reference's exactness bound (row sums of 16-bit limbs below
    2^24)."""
    max_abs_row = int(np.abs(M).sum(axis=1).max())
    if max_abs_row * 65535 >= (1 << 24):
        raise ValueError("linear map too wide for exact limb sums")
    return max_abs_row


def linear_combine_plain(X, M):
    """The exact mod-P linear map, on any device: X (NLIMBS, k, B)
    canonical residues (int32), M (n_out, k) small ints (any sign) ->
    (NLIMBS, n_out, B) canonical int32. The reference's positive and
    negative integer sums (as int64 broadcast products summed over k: no
    integer matmul on CUDA), its borrow-free offset and _reduce_mod_p."""
    M = np.asarray(M, dtype=np.int64)
    max_abs_row = _map_bound(M)
    x = X.to(I64).unsqueeze(1)  # (NLIMBS, 1, k, B)

    def limb_sums(C):
        c = torch.from_numpy(C).to(X.device)[None, :, :, None]
        return (c * x).sum(dim=2)  # (NLIMBS, n_out, B)

    Sp = limb_sums(np.maximum(M, 0))
    zrow = torch.zeros_like(Sp[:1])
    if np.any(M < 0):
        Sn = limb_sums(np.maximum(-M, 0))
        off, _K = _offset_limbs(max_abs_row * 65536)
        acc = (torch.cat([Sp, zrow])
               + (_rows(off, Sp.ndim, X.device) - torch.cat([Sn, zrow])))
    else:
        acc = torch.cat([Sp, zrow])
    return _reduce_mod_p(acc).to(I32)


def _mul_cols(A, B):
    """(NLIMBS, k, B) x (NLIMBS, k, B) Montgomery products on the plain
    body, as one wide product (any device)."""
    nl, k, b = A.shape
    out = fm.mont_mul_body(A.reshape(nl, k * b).to(I64),
                           B.reshape(nl, k * b).to(I64), FQ)
    return out.to(I32).reshape(nl, k, b)


# --- symbolic derivation of the Fq12-multiply matrices -----------------
# Linear forms are dicts {input_index: int coeff}; the formulas below are
# the SAME algebra as the explicit fq6/fq12 code (and the oracle), just
# evaluated over symbols once at import.


def _sym_add(x, y):
    out = dict(x)
    for i, c in y.items():
        out[i] = out.get(i, 0) + c
        if not out[i]:
            del out[i]
    return out


def _sym_scale(x, k):
    return {i: c * k for i, c in x.items()}


def _sym_sub(x, y):
    return _sym_add(x, _sym_scale(y, -1))


def _sym2_add(a, b):
    return (_sym_add(a[0], b[0]), _sym_add(a[1], b[1]))


def _sym2_sub(a, b):
    return (_sym_sub(a[0], b[0]), _sym_sub(a[1], b[1]))


def _sym2_xi(a):
    return (_sym_sub(_sym_scale(a[0], 9), a[1]),
            _sym_add(_sym_scale(a[1], 9), a[0]))


def _derive_fq12_mul_maps():
    """Returns (MA, MB, MC): operand-prep maps (54 x 12) and the
    recombination map (12 x 54) of the Karatsuba/Toom Fq12 multiply."""
    a = [[({2 * (3 * h + i): 1}, {2 * (3 * h + i) + 1: 1})
          for i in range(3)] for h in range(2)]
    b = [[({2 * (3 * h + i) + 0: 1}, {2 * (3 * h + i) + 1: 1})
          for i in range(3)] for h in range(2)]

    def fq6_pairs(x, y):
        x0, x1, x2 = x
        y0, y1, y2 = y
        return [
            (x0, y0), (x1, y1), (x2, y2),
            (_sym2_add(x1, x2), _sym2_add(y1, y2)),
            (_sym2_add(x0, x1), _sym2_add(y0, y1)),
            (_sym2_add(x0, x2), _sym2_add(y0, y2)),
        ]

    pairs = (fq6_pairs(a[0], b[0]) + fq6_pairs(a[1], b[1])
             + fq6_pairs([_sym2_add(a[0][i], a[1][i]) for i in range(3)],
                         [_sym2_add(b[0][i], b[1][i]) for i in range(3)]))
    # operand rows: per fq2 pair (x, y) the 3 Karatsuba column pairs
    arows, brows = [], []
    for x, y in pairs:
        arows += [x[0], x[1], _sym_add(x[0], x[1])]
        brows += [y[0], y[1], _sym_add(y[0], y[1])]

    def to_mat(rows, n_in):
        M = np.zeros((len(rows), n_in), dtype=np.int64)
        for r, form in enumerate(rows):
            for i, c in form.items():
                M[r, i] = c
        return M

    MA = to_mat(arows, 12)
    MB = to_mat(brows, 12)

    # product symbols: 3 per fq2 pair
    prods2 = []
    for pi in range(18):
        m0 = {3 * pi: 1}
        m1 = {3 * pi + 1: 1}
        m2 = {3 * pi + 2: 1}
        prods2.append((_sym_sub(m0, m1), _sym_sub(_sym_sub(m2, m0), m1)))

    def fq6_combine(t0, t1, t2, m12, m01, m02):
        c0 = _sym2_add(t0, _sym2_xi(_sym2_sub(_sym2_sub(m12, t1), t2)))
        c1 = _sym2_add(_sym2_sub(_sym2_sub(m01, t0), t1), _sym2_xi(t2))
        c2 = _sym2_add(_sym2_sub(_sym2_sub(m02, t0), t2), t1)
        return (c0, c1, c2)

    t0 = fq6_combine(*prods2[0:6])
    t1 = fq6_combine(*prods2[6:12])
    tm = fq6_combine(*prods2[12:18])
    # c0 = t0 + v*t1 ; v*(x0,x1,x2) = (xi*x2, x0, x1)
    vt1 = (_sym2_xi(t1[2]), t1[0], t1[1])
    c0 = tuple(_sym2_add(x, y) for x, y in zip(t0, vt1))
    c1 = tuple(_sym2_sub(_sym2_sub(x, y), z)
               for x, y, z in zip(tm, t0, t1))
    out_rows = []
    for six in (c0, c1):
        for coeff in six:
            out_rows.append(coeff[0])
            out_rows.append(coeff[1])
    MC = to_mat(out_rows, 54)
    return MA, MB, MC


_FQ12_MA, _FQ12_MB, _FQ12_MC = _derive_fq12_mul_maps()


def _fq12_coeff_stack(a):
    """Fq12 tuple tree -> (NLIMBS, 12, B) coefficient stack."""
    cols = []
    for six in a:
        for c in six:
            cols.append(c[0])
            cols.append(c[1])
    return torch.stack(cols, dim=1)


def _fq12_from_stack(X):
    c = [X[:, i] for i in range(12)]
    return (
        ((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
        ((c[6], c[7]), (c[8], c[9]), (c[10], c[11])),
    )


# ------------------------------------------------------------ Fq6 tower
# Fq6 = Fq2[v]/(v^3 - xi); triples of Fq2. Same algebra as the oracle
# (hostpairing.py fq6_mul), products lane-packed by the caller.


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def _fq6_prod_pairs(a, b):
    """The 6 independent Fq2 products of a Toom-style Fq6 multiply
    (oracle fq6_mul): t0, t1, t2, (a1+a2)(b1+b2), (a0+a1)(b0+b1),
    (a0+a2)(b0+b2)."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return [
        (a0, b0), (a1, b1), (a2, b2),
        (fq2_add(a1, a2), fq2_add(b1, b2)),
        (fq2_add(a0, a1), fq2_add(b0, b1)),
        (fq2_add(a0, a2), fq2_add(b0, b2)),
    ]


def _fq6_combine(t0, t1, t2, m12, m01, m02):
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_sub(m12, t1), t2)))
    c1 = fq2_add(fq2_sub(fq2_sub(m01, t0), t1), fq2_mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_sub(m02, t0), t2), t1)
    return (c0, c1, c2)


def fq6_mul(a, b):
    return _fq6_combine(*fq2_mul_many(_fq6_prod_pairs(a, b)))


def fq6_mul_v(a):
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_zero(b, device):
    return (fq2_zero(b, device),) * 3


def fq6_one(b, device):
    return (fq2_one(b, device), fq2_zero(b, device), fq2_zero(b, device))


# ------------------------------------------------------------ Fq12 tower
# Fq12 = Fq6[w]/(w^2 - v); pairs of Fq6. One multiply = 18 Fq2 products
# = 54 Fq lanes in a single mont_mul.


def fq12_mul_plain(A, B):
    """The plain version of the fused Fq12 multiply, on (NLIMBS, 12, B)
    int32 coefficient stacks (any device): the reference's composition,
    operand maps MA and MB, the 54 Montgomery products, the recombination
    map MC (derived symbolically from the oracle's Karatsuba/Toom
    formulas at import)."""
    A = linear_combine_plain(A, _FQ12_MA)
    Bv = linear_combine_plain(B, _FQ12_MB)
    return linear_combine_plain(_mul_cols(A, Bv), _FQ12_MC)


def fq12_mul_stack(A, B):
    """The Fq12 multiply on (NLIMBS, 12, B) coefficient stacks (B may be
    A, for a square): one fused launch for CUDA tensors, the plain
    version for CPU ones."""
    if A.is_cuda:
        return kernels.fq12_mul(A, B)
    return fq12_mul_plain(A, B)


def _fq12_one_stack(b, device):
    X = torch.zeros((NLIMBS, 12, b), dtype=I32, device=device)
    X[:, 0] = _one(b, device)
    return X


def fq12_mul(a, b):
    return _fq12_from_stack(fq12_mul_stack(_fq12_coeff_stack(a),
                                           _fq12_coeff_stack(b)))


def fq12_square(a):
    A = _fq12_coeff_stack(a)
    return _fq12_from_stack(fq12_mul_stack(A, A))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    """(a0 + a1 w)^-1 via the norm a0^2 - v a1^2 in Fq6, whose own
    inversion reduces to ONE Fq inversion (oracle fq6_inv/fq12_inv)."""
    a0, a1 = a
    sq = fq2_mul_many(_fq6_prod_pairs(a0, a0) + _fq6_prod_pairs(a1, a1))
    t = fq6_sub(_fq6_combine(*sq[0:6]), fq6_mul_v(_fq6_combine(*sq[6:12])))
    # fq6_inv(t), products batched per dependency layer
    t0, t1, t2 = t
    p = fq2_mul_many([
        (t0, t0), (t1, t2), (t2, t2), (t0, t1), (t1, t1), (t0, t2),
    ])
    c0 = fq2_sub(p[0], fq2_mul_xi(p[1]))
    c1 = fq2_sub(fq2_mul_xi(p[2]), p[3])
    c2 = fq2_sub(p[4], p[5])
    q = fq2_mul_many([(t2, c1), (t1, c2), (t0, c0)])
    den = fq2_add(fq2_mul_xi(fq2_add(q[0], q[1])), q[2])
    dinv = fq2_inv(den)
    tinv = tuple(fq2_mul_many([(c0, dinv), (c1, dinv), (c2, dinv)]))
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_one(b, device):
    return (fq6_one(b, device), fq6_zero(b, device))


def _fq12_map(a, f):
    """Apply an Fq-tensor map over all 12 coefficients."""
    return tuple(
        tuple((f(c[0]), f(c[1])) for c in six) for six in a
    )


def fq12_lane(a, i):
    """Slice lane i of a width-B Fq12 to width 1."""
    return _fq12_map(a, lambda c: c[:, i:i + 1])


def fq12_stack(a):
    """Fq12 -> (12, NLIMBS, B) tensor (coefficient-major: the two Fq6
    halves' Fq2 coefficients flattened as (c0, c1) pairs)."""
    cols = []
    for six in a:
        for c in six:
            cols.append(c[0])
            cols.append(c[1])
    return torch.stack(cols)


# ------------------------------------------------- Frobenius endomorphism
# Gamma constants from the oracle (host ints), embedded in Montgomery form.


_G1C = [tuple(int_to_limbs(x * FQ.mont_r % P) for x in g)
        for g in hp._FROB_GAMMA1]
_G2C = [tuple(int_to_limbs(x * FQ.mont_r % P) for x in g)
        for g in hp._FROB_GAMMA2]


def _bconst(limbs_np, b, device):
    """A constant broadcast to (NLIMBS, b), materialized: the kernels
    read lanes at unit stride."""
    col = torch.from_numpy(limbs_np.astype(np.int32)).reshape(NLIMBS, 1)
    return col.to(device).expand(NLIMBS, b).contiguous()


def _fq2_mul_const(a, const):
    b, dev = a[0].shape[1], a[0].device
    cc = (_bconst(const[0], b, dev), _bconst(const[1], b, dev))
    return fq2_mul(a, cc)


def fq12_frobenius(a):
    (c00, c01, c02), (c10, c11, c12) = a
    b, dev = c00[0].shape[1], c00[0].device
    coeffs = [fq2_conj(c) for c in (c00, c01, c02, c10, c11, c12)]
    gammas = [None, _G1C[2], _G1C[4], _G1C[1], _G1C[3], _G1C[5]]
    ps = [
        (c, (_bconst(g[0], b, dev), _bconst(g[1], b, dev)))
        for c, g in zip(coeffs[1:], gammas[1:])
    ]
    out = fq2_mul_many(ps)
    return ((coeffs[0], out[0], out[1]), (out[2], out[3], out[4]))


def fq12_frobenius2(a):
    (c00, c01, c02), (c10, c11, c12) = a
    b, dev = c00[0].shape[1], c00[0].device
    gammas = [_G2C[2], _G2C[4], _G2C[1], _G2C[3], _G2C[5]]
    ps = [
        (c, (_bconst(g[0], b, dev), _bconst(g[1], b, dev)))
        for c, g in zip((c01, c02, c10, c11, c12), gammas)
    ]
    out = fq2_mul_many(ps)
    return ((c00, out[0], out[1]), (out[2], out[3], out[4]))


# ------------------------------------------------------------ Miller loop


# The line's coefficient slots in _fq12_coeff_stack's order (oracle
# _sparse_line: c0 + c3 vw + c4 w, c0 = (py, 0)); csrc/tower.cu kLinePy,
# kLineC3, kLineC4.
_LINE_PY, _LINE_C3, _LINE_C4 = 0, 6, 8


def _g2_stack(q):
    """An affine G2 point ((x0, x1), (y0, y1)) -> (NLIMBS, 4, B) stack."""
    return torch.stack([q[0][0], q[0][1], q[1][0], q[1][1]], dim=1)


def _g2_from_stack(T):
    return ((T[:, 0], T[:, 1]), (T[:, 2], T[:, 3]))


def miller_step_plain(mode, T, Q, P):
    """The plain version of the Miller step kernel, on any device: the
    reference's _line_double (mode kernels.MILLER_DOUBLE) or _line_add
    (MILLER_ADD), products batched per dependency layer as there, on the
    plain bodies (field.add_body, sub_body, neg_body, mont_mul_body,
    inv_mont_body), so it launches no package kernel. T, Q: (NLIMBS, 4, B)
    int32 stacks (x0, x1, y0, y1), Q None when doubling; P = (px, py),
    (NLIMBS, B) int32. Returns (T', line): a (NLIMBS, 4, B) stack and the
    line's (NLIMBS, 12, B) coefficient stack."""
    b = T.shape[2]

    def add(x, y):
        return fm.add_body(x, y, FQ)

    def sub(x, y):
        return fm.sub_body(x, y, FQ)

    def sub2(x, y):
        return (sub(x[0], y[0]), sub(x[1], y[1]))

    def mul_many(pairs):  # _mul_many: one wide product
        return fm.mont_mul_body(torch.cat([x for x, _ in pairs], dim=1),
                                torch.cat([y for _, y in pairs], dim=1),
                                FQ).split(b, dim=1)

    def fq2_mul_many_(ps):  # fq2_mul_many: Karatsuba, one wide product
        p = mul_many([t for x, y in ps for t in (
            (x[0], y[0]), (x[1], y[1]), (add(x[0], x[1]), add(y[0], y[1])))])
        return [(sub(p[3 * i], p[3 * i + 1]),
                 sub(sub(p[3 * i + 2], p[3 * i]), p[3 * i + 1]))
                for i in range(len(ps))]

    xt, yt = _g2_from_stack(T.to(I64))
    if mode == kernels.MILLER_DOUBLE:
        xt2 = fq2_mul_many_([(xt, xt)])[0]
        num = tuple(add(add(c, c), c) for c in xt2)
        den = (add(yt[0], yt[0]), add(yt[1], yt[1]))
        xr, yr = xt, yt
    else:
        xr, yr = _g2_from_stack(Q.to(I64))
        num, den = sub2(yt, yr), sub2(xt, xr)
    # fq2_inv(den): conj(den) / (den0^2 + den1^2), inv(0) = 0
    sq = mul_many([(den[0], den[0]), (den[1], den[1])])
    ninv = fm.inv_mont_body(add(sq[0], sq[1]), FQ)
    inv = mul_many([(den[0], ninv), (den[1], ninv)])
    lam = fq2_mul_many_([(num, (inv[0], fm.neg_body(inv[1], FQ)))])[0]
    ll, lx = fq2_mul_many_([(lam, lam), (lam, xr)])
    if mode == kernels.MILLER_DOUBLE:
        x3 = sub2(ll, (add(xt[0], xt[0]), add(xt[1], xt[1])))
    else:
        x3 = sub2(sub2(ll, xt), xr)
    c4 = sub2(lx, yr)
    px = P[0].to(I64)
    ly, lp = fq2_mul_many_([(lam, sub2(xt, x3)),
                            (lam, (px, torch.zeros_like(px)))])
    y3 = sub2(ly, yt)
    c3 = (fm.neg_body(lp[0], FQ), fm.neg_body(lp[1], FQ))
    line = torch.zeros((NLIMBS, 12, b), dtype=I32, device=T.device)
    line[:, _LINE_PY] = P[1]
    line[:, _LINE_C3:_LINE_C3 + 2] = torch.stack(c3, dim=1)
    line[:, _LINE_C4:_LINE_C4 + 2] = torch.stack(c4, dim=1)
    return _g2_stack((x3, y3)).to(I32), line


def _miller_step(mode, T, Q, P):
    """One affine Miller step on stacks (miller_step_plain's arguments and
    results): one launch for CUDA tensors, the plain version for CPU
    ones."""
    if T.is_cuda:
        return kernels.miller_step(mode, T, Q, *P)
    return miller_step_plain(mode, T, Q, P)


def _line_double(t, px, py):
    """(2T, line at P), affine tangent (oracle _line_double), on the
    reference's tuples: one Miller step."""
    T, line = _miller_step(kernels.MILLER_DOUBLE, _g2_stack(t), None,
                           (px, py))
    return _g2_from_stack(T), _fq12_from_stack(line)


def _line_add(t, q, px, py):
    """(T+Q, line at P), affine chord (oracle _line_add), on the
    reference's tuples: one Miller step."""
    T, line = _miller_step(kernels.MILLER_ADD, _g2_stack(t), _g2_stack(q),
                           (px, py))
    return _g2_from_stack(T), _fq12_from_stack(line)


def _g2_frobenius_twist(q):
    x, y = q
    return (
        _fq2_mul_const(fq2_conj(x), _G1C[2]),
        _fq2_mul_const(fq2_conj(y), _G1C[3]),
    )


_ATE_BITS = np.asarray(
    [int(c) for c in bin(ATE_LOOP_COUNT)[3:]], dtype=np.int32
)  # MSB skipped, as in the oracle


def miller_loop_lanes(px, py, qx, qy):
    """Per-lane Miller loops f_{6u+2, Q_i}(P_i) — all pairs in parallel.

    px/py: (NLIMBS, B) G1 affine Montgomery coords; qx/qy: Fq2 pairs of
    the same width. Identity pairs must be filtered by the caller (the
    engine skips them, oracle miller_loop). f only multiplies and T only
    steps, so both stay stacks, and each step's line goes to the multiply
    as the step wrote it."""
    b = px.shape[1]
    q = ((qx[0], qx[1]), (qy[0], qy[1]))
    Q, P = _g2_stack(q), (px, py)
    f, T = _fq12_one_stack(b, px.device), Q
    for bit in _ATE_BITS:
        f = fq12_mul_stack(f, f)
        T, line = _miller_step(kernels.MILLER_DOUBLE, T, None, P)
        f = fq12_mul_stack(f, line)
        if bit:
            T, line = _miller_step(kernels.MILLER_ADD, T, Q, P)
            f = fq12_mul_stack(f, line)
    q1 = _g2_frobenius_twist(q)
    q2 = _g2_frobenius_twist(q1)
    q2 = (q2[0], fq2_neg(q2[1]))
    T, line = _miller_step(kernels.MILLER_ADD, T, _g2_stack(q1), P)
    f = fq12_mul_stack(f, line)
    _, line = _miller_step(kernels.MILLER_ADD, T, _g2_stack(q2), P)
    return _fq12_from_stack(fq12_mul_stack(f, line))


# ------------------------------------------------------ final exponentiation

_HARD_EXP = (P**4 - P**2 + 1) // R
_HARD_BITS = np.asarray(
    [(_HARD_EXP >> i) & 1 for i in range(_HARD_EXP.bit_length())],
    dtype=np.int32,
)


def fq12_pow_bits(a, bits):
    """Square-and-multiply over an LSB-first static bit array; a zero bit
    skips the product the reference computes and discards, and the last
    squaring, whose result the reference discards, is not computed. The
    result and the base stay coefficient stacks in between."""
    base = _fq12_coeff_stack(a)
    result = _fq12_one_stack(base.shape[2], base.device)
    for i, bit in enumerate(bits):
        if bit:
            result = fq12_mul_stack(result, base)
        if i + 1 < len(bits):
            base = fq12_mul_stack(base, base)
    return _fq12_from_stack(result)


def final_exponentiation(f):
    """f^((p^12-1)/r): easy part exactly as the oracle; hard part as a
    plain exponentiation by (p^4-p^2+1)/r."""
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))
    f2 = fq12_mul(fq12_frobenius2(f1), f1)
    return fq12_pow_bits(f2, _HARD_BITS)


# ------------------------------------------------------------- public API


@torch.inference_mode()
def pairing_product(g1, g2, n):
    """g1: (2, NLIMBS, n) Montgomery affine; g2: (4, NLIMBS, n) Montgomery
    Fq2 affine, int32 tensors on one device. Returns the
    final-exponentiated product as a (12, NLIMBS, 1) tensor (the
    reference's _pairing_product_fn). Runs in inference mode: its tens of
    thousands of small ops skip autograd's per-op bookkeeping."""
    f = miller_loop_lanes(
        g1[0], g1[1], (g2[0], g2[1]), (g2[2], g2[3])
    )
    total = fq12_lane(f, 0)
    for i in range(1, n):
        total = fq12_mul(total, fq12_lane(f, i))
    return fq12_stack(final_exponentiation(total))


@torch.inference_mode()
def miller_lanes(g1, g2):
    """Raw per-lane Miller loop outputs, (12, NLIMBS, B) — for
    differential tests against the oracle (the reference's
    _miller_lanes_fn)."""
    f = miller_loop_lanes(
        g1[0], g1[1], (g2[0], g2[1]), (g2[2], g2[3])
    )
    return fq12_stack(f)


def mont_cols(vals):
    """List of ints -> (NLIMBS, len) int32 Montgomery limb array."""
    mont = [v * FQ.mont_r % P for v in vals]
    return np.ascontiguousarray(ints_to_limbs(mont).T.astype(np.int32))


def pairing_check_device(pairs, device=None) -> bool:
    """True iff prod e(Pi, Qi) == 1, computed on `device` (None: the CUDA
    card, raising if there is none) (DualMSM::check semantics,
    kzg/msm.rs:185-203). Identity pairs skip, matching the engine's
    multi_miller_loop."""
    dev = resolve_device(device)
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return True
    g1 = np.stack([
        mont_cols([p[0] for p, _ in live]),
        mont_cols([p[1] for p, _ in live]),
    ])
    g2 = np.stack([
        mont_cols([q[0][0] for _, q in live]),
        mont_cols([q[0][1] for _, q in live]),
        mont_cols([q[1][0] for _, q in live]),
        mont_cols([q[1][1] for _, q in live]),
    ])
    out = pairing_product(torch.from_numpy(g1).to(dev),
                          torch.from_numpy(g2).to(dev), n=len(live))
    out = out.cpu().numpy()
    one = np.zeros_like(out)
    one[0, :, 0] = int_to_limbs(FQ.mont_r % P)  # Montgomery 1 in c000
    return bool((out == one).all())


def fq12_from_device(arr, lane: int = 0):
    """(12, NLIMBS, B) limbs (a tensor on any device, or an array) ->
    oracle Fq12 nested-int tuples (canonical form) for differential
    tests."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    rinv = pow(FQ.mont_r, -1, P)
    vals = [limbs_to_int(arr[i, :, lane]) * rinv % P for i in range(12)]

    def fq2(i):
        return (vals[i], vals[i + 1])

    return (
        (fq2(0), fq2(2), fq2(4)),
        (fq2(6), fq2(8), fq2(10)),
    )
