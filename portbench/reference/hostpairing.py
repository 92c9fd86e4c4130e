"""Frozen copy of halo2_verifier_tpu/ops/hostpairing.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Host-side BN254 pairing (exact, Python ints).

Implements the full Fq2/Fq6/Fq12 tower and an optimal-ate pairing with a
multi-Miller-loop + final-exponentiation API mirroring the reference's
pairing usage in DualMSM::check (poly/kzg/msm.rs:185-203).

Tower (standard BN254 construction, matching halo2curves):
    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
    Fq12 = Fq6[w] / (w^2 - v)

G2 lives on the D-twist E'/Fq2: y^2 = x^3 + 3/xi; untwist is
(x, y) -> (x w^2, y w^3).

Fq6 elements are triples of Fq2; Fq12 elements are pairs of Fq6.
"""

from __future__ import annotations

from .constants import ATE_LOOP_COUNT, P, R, XI
from . import hostfield as hf
from .hostfield import (
    FQ2_ONE,
    FQ2_ZERO,
    fq2_add,
    fq2_inv,
    fq2_mul,
    fq2_mul_scalar,
    fq2_neg,
    fq2_square,
    fq2_sub,
)

# ----------------------------------------------------------------------- Fq6

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq2_mul_xi(a):
    """Multiply by xi = 9 + u."""
    return (
        (9 * a[0] - a[1]) % P,
        (9 * a[1] + a[0]) % P,
    )


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(
        t0,
        fq2_mul_xi(
            fq2_sub(
                fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), t1), t2
            )
        ),
    )
    c1 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), t0), t1),
        fq2_mul_xi(t2),
    )
    c2 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), t0), t2),
        t1,
    )
    return (c0, c1, c2)


def fq6_square(a):
    return fq6_mul(a, a)


def fq6_mul_fq2(a, s):
    return (fq2_mul(a[0], s), fq2_mul(a[1], s), fq2_mul(a[2], s))


def fq6_mul_v(a):
    """Multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_square(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_square(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_square(a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_add(fq2_mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))), fq2_mul(a0, c0)),
        FQ2_ZERO,
    )
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# ---------------------------------------------------------------------- Fq12

FQ12_ONE = (FQ6_ONE, FQ6_ZERO)
FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_square(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    """Conjugation = Frobenius^6: a0 - a1 w."""
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_square(a0), fq6_mul_v(fq6_square(a1)))
    tinv = fq6_inv(t)
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_square(base)
        e >>= 1
    return result


# -------------------------------------------------- Frobenius endomorphism

def _fq2_pow(a, e):
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_square(base)
        e >>= 1
    return result


# gamma constants for the p-power Frobenius on the tower:
#   frob(c) for c in Fq2 is conjugation; v^p = gamma12 * v, w^p = gamma16 * w
# gamma1i = xi^((i(p-1))/6)
_FROB_GAMMA1 = [_fq2_pow(XI, i * (P - 1) // 6) for i in range(6)]
_FROB_GAMMA2 = [
    fq2_mul(g, hf.fq2_conj(g)) for g in _FROB_GAMMA1
]  # xi^(i(p^2-1)/6), lies in Fq


def fq12_frobenius(a):
    """a^p on the Fq12 tower via coefficient-wise conjugation + gammas."""
    (c00, c01, c02), (c10, c11, c12) = a
    c00 = hf.fq2_conj(c00)
    c01 = fq2_mul(hf.fq2_conj(c01), _FROB_GAMMA1[2])
    c02 = fq2_mul(hf.fq2_conj(c02), _FROB_GAMMA1[4])
    c10 = fq2_mul(hf.fq2_conj(c10), _FROB_GAMMA1[1])
    c11 = fq2_mul(hf.fq2_conj(c11), _FROB_GAMMA1[3])
    c12 = fq2_mul(hf.fq2_conj(c12), _FROB_GAMMA1[5])
    return ((c00, c01, c02), (c10, c11, c12))


def fq12_frobenius2(a):
    """a^(p^2): gammas are in Fq, no conjugation."""
    (c00, c01, c02), (c10, c11, c12) = a
    g = _FROB_GAMMA2
    c01 = fq2_mul(c01, g[2])
    c02 = fq2_mul(c02, g[4])
    c10 = fq2_mul(c10, g[1])
    c11 = fq2_mul(c11, g[3])
    c12 = fq2_mul(c12, g[5])
    return ((c00, c01, c02), (c10, c11, c12))


# ------------------------------------------------------------- Miller loop

def _sparse_line(c0, c3, c4):
    """Fq12 element c0 + c3 v w + c4 w ... in the sparse (034) layout used for
    D-twist line evaluations; c0, c3, c4 are Fq2."""
    return ((c0, FQ2_ZERO, FQ2_ZERO), (c3, c4, FQ2_ZERO))


def _line_double(t, p):
    """Double T on the twist; return (2T, line eval at P) for D-twist lines.

    Affine tangent-line formulas; t is a twist point (Fq2 affine), p is a G1
    affine point.
    """
    (xt, yt) = t
    px, py = p
    lam = fq2_mul(fq2_mul_scalar(fq2_square(xt), 3), fq2_inv(fq2_mul_scalar(yt, 2)))
    x3 = fq2_sub(fq2_square(lam), fq2_mul_scalar(xt, 2))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt)
    # line: l(P) = py - lam*px*w^... ; with D-twist untwist (x w^2, y w^3) the
    # line through T,(T) evaluated at P is:  py * 1 + (-lam*px) vw? —
    # canonical sparse form: c0 = py (scalar), c3 = -lam * px, c4 = lam*xt - yt
    c0 = ((py) % P, 0)
    c3 = fq2_mul_scalar(fq2_neg(lam), px)
    c4 = fq2_sub(fq2_mul(lam, xt), yt)
    return (x3, y3), _sparse_line(c0, c3, c4)


def _line_add(t, q, p):
    """Add Q to T on the twist; return (T+Q, line eval at P)."""
    (xt, yt) = t
    (xq, yq) = q
    lam = fq2_mul(fq2_sub(yt, yq), fq2_inv(fq2_sub(xt, xq)))
    x3 = fq2_sub(fq2_sub(fq2_square(lam), xt), xq)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt)
    c0 = (p[1] % P, 0)
    c3 = fq2_mul_scalar(fq2_neg(lam), p[0])
    c4 = fq2_sub(fq2_mul(lam, xq), yq)
    return (x3, y3), _sparse_line(c0, c3, c4)


def _g2_frobenius_twist(q):
    """psi(x, y) = (x^p * gamma12?, ...): Frobenius on the twist curve.

    For the D-twist with untwist (x w^2, y w^3):
        psi(x, y) = (conj(x) * xi^((p-1)/3), conj(y) * xi^((p-1)/2))
    """
    x, y = q
    return (
        fq2_mul(hf.fq2_conj(x), _FROB_GAMMA1[2]),
        fq2_mul(hf.fq2_conj(y), _FROB_GAMMA1[3]),
    )


def miller_loop(p, q):
    """Optimal ate Miller loop f_{6u+2, Q}(P) with the BN254 Frobenius tail.

    p: G1 affine point (ints), q: G2 affine point (Fq2 pairs). Either being
    the identity yields 1 (mirroring halo2curves' multi_miller_loop skipping).
    """
    if p is None or q is None:
        return FQ12_ONE
    t = q
    f = FQ12_ONE
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip MSB
    for b in bits:
        f = fq12_square(f)
        t, line = _line_double(t, p)
        f = fq12_mul(f, line)
        if b == "1":
            t, line = _line_add(t, q, p)
            f = fq12_mul(f, line)
    q1 = _g2_frobenius_twist(q)
    q2 = _g2_frobenius_twist(q1)
    q2 = (q2[0], fq2_neg(q2[1]))  # -psi^2(Q)
    t, line = _line_add(t, q1, p)
    f = fq12_mul(f, line)
    _, line = _line_add(t, q2, p)
    f = fq12_mul(f, line)
    return f


def multi_miller_loop(pairs):
    """Product of Miller loops (pairing engine's multi_miller_loop)."""
    f = FQ12_ONE
    for p, q in pairs:
        f = fq12_mul(f, miller_loop(p, q))
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r).

    Easy part via conjugation/inversion + Frobenius^2; hard part as a plain
    exponentiation by (p^4 - p^2 + 1)/r (correct, not yet the fastest chain —
    the device path will use the cyclotomic addition chain).
    """
    # easy part: f^((p^6-1)(p^2+1))
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))
    f2 = fq12_mul(fq12_frobenius2(f1), f1)
    # hard part
    e = (P**4 - P**2 + 1) // R
    return fq12_pow(f2, e)


def pairing(p, q):
    return final_exponentiation(miller_loop(p, q))


def pairing_check(pairs) -> bool:
    """True iff prod e(Pi, Qi) == 1 (DualMSM::check, kzg/msm.rs:185-203)."""
    return final_exponentiation(multi_miller_loop(pairs)) == FQ12_ONE
