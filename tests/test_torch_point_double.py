"""PyTorch port, the doubling kernel's schedule (csrc/point_double.cu):
its radix-2^29 arithmetic (mont29.cuh: the inputs read as 16 X, 16 Y,
16 Z, sqr29, mul2_29's one reduction for two products, lazy values,
half29, reduce_top29) written as formulas on Python integers, bit for
bit against the JAX package's OPS16.double_body and the port's
curve.double_plain on seeded canonical triples (not only curve points:
the formulas are polynomial maps) and the edge triples
(constants.double_edge_triples). Every bound the kernel's comments claim
is asserted where the formulas run, and at the limbs' and the values'
worst cases."""

import os
import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import lmcurve as lc
from halo2_verifier_tpu_torch.ops import curve
from halo2_verifier_tpu_torch.ops.constants import (
    FOLD_EDGE, FQ_EDGE, MONT_R_FQ, P, double_edge_triples)
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

SRC = os.path.join(os.path.dirname(__file__), "..",
                   "halo2_verifier_tpu_torch", "csrc", "point_double.cu")
MASK32 = (1 << 32) - 1
M29 = (1 << 29) - 1
NINV29 = (-pow(P, -1, 1 << 29)) % (1 << 29)
Q29 = [(P >> (29 * j)) & M29 for j in range(9)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch version runs many small ops: with one intra-op
    thread per process it does not fight the other test workers for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mont(a, b):
    return a * b * pow(1 << 256, -1, P) % P


def _reference(X, Y, Z):
    """RCB15 algorithm 9 in the reference's order on canonical residues."""
    t0, t1, t3 = _mont(Y, Y), _mont(Y, Z), _mont(X, Y)
    t2 = 9 * _mont(Z, Z) % P
    z3 = 8 * t0 % P
    y3 = (t0 + t2) % P
    t0m = (t0 - 3 * t2) % P
    return (2 * _mont(t0m, t3) % P, (_mont(t2, z3) + _mont(t0m, y3)) % P,
            _mont(t1, z3))


# ------------------------------------------------ radix 2^29 (mont29.cuh)

def _val29(limbs):
    return sum(v << (29 * j) for j, v in enumerate(limbs))


def _col(v):
    assert 0 <= v < 1 << 64  # a 64-bit column
    return v


def _u32(v):
    assert 0 <= v < 1 << 32
    return v


def _redc29(t):
    t = list(t)
    for i in range(9):
        m = ((t[i] & MASK32) * NINV29) & M29
        for j in range(9):
            t[i + j] = _col(t[i + j] + m * Q29[j])
        t[i + 1] = _col(t[i + 1] + (t[i] >> 29))
    c = t[9:]
    u = ([c[0] & M29] + [(c[j] & M29) + (c[j - 1] >> 29) for j in range(1, 8)]
         + [c[7] >> 29])
    r = ([u[0]] + [(u[j] & M29) + (u[j - 1] >> 29) for j in range(1, 8)]
         + [u[8] + (u[7] >> 29)])
    assert max(r[:8]) < (1 << 29) + (1 << 7)
    return [_u32(v) for v in r]


def _columns(pairs, square=False):
    t = [0] * 17
    for a, b in pairs:
        if square:  # sqr29: cross products doubled
            for i in range(9):
                for j in range(i + 1, 9):
                    t[i + j] = _col(t[i + j] + (a[i] << 1) * a[j])
                t[2 * i] = _col(t[2 * i] + a[i] * a[i])
        else:
            for i in range(9):
                for j in range(9):
                    t[i + j] = _col(t[i + j] + a[i] * b[j])
    return t


def _prod29(pairs, square=False):
    """mul29 (one pair), sqr29 (square) or mul2_29 (two pairs): the
    result is below sum(a b) / 2^261 + N."""
    r = _redc29(_columns(pairs, square))
    bound = sum(_val29(a) * _val29(b) for a, b in pairs) / Fraction(1 << 261)
    assert _val29(r) < bound + P
    assert (_val29(r) - sum(_val29(a) * _val29(b) for a, b in pairs)
            * pow(1 << 261, -1, P)) % P == 0
    return r


def _normalize29(a):
    r, c = [], 0
    for v in a[:8]:
        v = _u32(v + c)
        r.append(v & M29)
        c = v >> 29
    return r + [_u32(a[8] + c)]


def _from_words(x, s):
    return [((x << s) >> (29 * j)) & M29 for j in range(9)]


def _shl29(a, k):
    assert max(a[:8]) <= M29
    return _normalize29([v << k for v in a])


def _half29(a):
    assert max(a) < 1 << 30
    odd = a[0] & 1
    u = [_u32(v + (Q29[j] if odd else 0)) for j, v in enumerate(a)]
    r = [(u[j] >> 1) + ((u[j + 1] & 1) << 28) for j in range(8)]
    r.append(u[8] >> 1)
    assert max(r) < 1 << 30
    assert _val29(r) * 2 == _val29(a) + odd * P
    return r


def _reduce_top29(a):
    e = _normalize29(a)
    assert _val29(e) < 1 << 258
    q = e[8] // (Q29[8] + 1)
    v = _val29(e) - q * P
    assert 0 <= v < P + (1 << 237)
    return [(v >> (29 * j)) & M29 for j in range(8)] + [v >> 232]


def _words29(a, subs):
    v = _val29(_normalize29(a))
    assert v < 1 << 256
    for _ in range(subs):
        v = v - P if v >= P else v
    assert v < P
    return v


def _bias29():
    """BIAS29 as point_double.cu holds it."""
    with open(SRC) as f:
        body = re.search(r"BIAS29\[9\] = \{([^}]*)\}", f.read()).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)]


def double_r29(X, Y, Z, shift=4):
    """double_r29 in point_double.cu, value for value; shift is the
    inputs' scaling (4: 16 X, 16 Y, 16 Z, the kernel's)."""
    bias = _bias29()
    x, y, z = (_from_words(v, shift) for v in (X, Y, Z))
    e0 = _normalize29(_prod29([(y, y)], square=True))
    ez = _normalize29(_prod29([(z, z)], square=True))
    t1 = _prod29([(y, z)])
    t3 = _prod29([(x, y)])
    ez8 = _shl29(ez, 3)
    t2 = _normalize29([a + b for a, b in zip(ez8, ez)])
    z3h = _shl29(e0, 2)
    y3 = [a + b for a, b in zip(e0, t2)]
    assert all(3 * b <= c for b, c in zip(t2[:8], bias[:8]))
    t0m = _normalize29([_u32(a + c - 3 * b)
                        for a, b, c in zip(e0, t2, bias)])
    y3h = _half29(y3)
    X3 = _words29(_prod29([(t0m, t3)]), 2)
    Y3 = _words29(_reduce_top29(_prod29([(t2, z3h), (t0m, y3h)])), 1)
    Z3 = _words29(_prod29([(t1, z3h)]), 1)
    return X3, Y3, Z3


# ----------------------------------------------------------------- tests

def _triples(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P
            for _ in range(3 * n)]
    return [tuple(vals[3 * i:3 * i + 3]) for i in range(n)]


def _cases():
    return double_edge_triples() + _triples(40, 9)


def test_edge_triples_cover_the_edges():
    t = double_edge_triples()
    assert (0, MONT_R_FQ, 0) in t and (0, 0, 0) in t
    for c in range(3):
        assert {v[c] for v in t} >= set(FQ_EDGE)
    for u, v in FOLD_EDGE:
        assert (u, v, v) in t and (u, u, v) in t  # X*Y and Y*Z
    assert all(0 <= v < P for tr in t for v in tr)


def test_schedules_match_the_reference_bodies():
    """The kernel's formulas equal the JAX package's double_body and the
    port's plain version on every case, bit for bit."""
    cases = _cases()
    cols = [np.ascontiguousarray(ints_to_limbs([c[k] for c in cases]).T)
            for k in range(3)]
    want = lc.OPS16.double_body(tuple(jnp.asarray(c) for c in cols))
    want = [limbs_to_ints(np.asarray(w).T) for w in want]
    plain = curve.double_plain(tuple(torch.from_numpy(c.astype(np.int32))
                                     for c in cols))
    plain = [limbs_to_ints(p.numpy().T) for p in plain]
    assert plain == want
    for i, (X, Y, Z) in enumerate(cases):
        ref = tuple(w[i] for w in want)
        assert _reference(X, Y, Z) == ref, i
        assert double_r29(X, Y, Z) == ref, i


def _operands29():
    """Exact limbs of FQ_EDGE and seeded values, unscaled and as the
    kernel reads them (16 v), and wide limbs (below 2^30, as y3 / 2)."""
    vals = FQ_EDGE + [v for t in _triples(8, 4) for v in t]
    exact = [_from_words(v, s) for v in vals for s in (0, 4)]
    wide = [[M29 + (1 << 29)] * 9, [(1 << 30) - 1] * 8 + [M29]]
    return exact, wide


def test_mul2_29_is_two_products_and_an_add():
    """mul2_29's one reduction of two summed column sets gives the
    residue of two mul29 products added, below sum(a b) / 2^261 + N."""
    exact, wide = _operands29()
    n = len(exact)
    for k, a in enumerate(exact):
        b, c = exact[(3 * k + 1) % n], exact[(5 * k + 2) % n]
        for d in (exact[(7 * k + 3) % n], wide[k % 2]):
            two = _val29(_prod29([(a, b), (c, d)]))
            one = _val29(_prod29([(a, b)])) + _val29(_prod29([(c, d)]))
            assert (two - one) % P == 0
    for u, v in FOLD_EDGE:  # both products on the fold's edge
        a, b = _from_words(u, 4), _from_words(v, 4)
        assert _val29(_prod29([(a, b), (b, a)])) % P == (
            2 * u * v * 2 ** 8 * pow(1 << 261, -1, P) % P)


def test_sqr29_equals_the_product():
    """sqr29's doubled cross products give mul29(a, a)'s residue."""
    exact, _ = _operands29()
    for a in exact:
        sq = _val29(_prod29([(a, a)], square=True))
        assert sq % P == _val29(_prod29([(a, a)])) % P == (
            _val29(a) ** 2 * pow(1 << 261, -1, P) % P)


def test_radix29_helpers_at_worst_case():
    """half29 halves mod N for limbs below 2^30, odd or even; shl29 keeps
    limbs exact; reduce_top29 leaves below 2N any value below 2^258;
    from_words<4> splits 16 x exactly for x up to 2^256 - 1."""
    top = [(1 << 30) - 1] * 9
    for a in (top, [v - 1 for v in top], [0] * 9, Q29):
        h = _half29(a)
        assert (2 * _val29(h) - _val29(a)) % P == 0
    for x in (P - 1, (1 << 256) - 1, 0):
        assert _val29(_from_words(x, 4)) == 16 * x
        e = _from_words(x % P, 0)
        for k in (2, 3):
            assert _val29(_shl29(e, k)) == (x % P) << k
    for v in ((1 << 258) - 1, 8 * P, P, 2 * P - 1, 0):
        limbs = [(v >> (29 * j)) & M29 for j in range(8)] + [v >> 232]
        r = _val29(_reduce_top29(limbs))
        assert r % P == v % P and r < 2 * P


def test_radix29_bounds_at_worst_case():
    """Every value bound of double_r29's comment, from the inputs' bound
    16 N through the products' a b / 2^261 + N; and the 64-bit columns of
    each product at its operands' limb maxima."""
    inp = 16 * P
    first = inp * inp / Fraction(1 << 261) + P
    assert first < Fraction(252, 100) * P
    t2 = 9 * first
    z3h = 4 * first
    assert 3 * t2 < 68 * P and t2 < Fraction(227, 10) * P
    t0m = first + 68 * P
    y3h = (first + t2 + P) / 2
    assert z3h < Fraction(101, 10) * P and t0m < Fraction(706, 10) * P
    assert y3h < Fraction(131, 10) * P
    x3 = t0m * first / Fraction(1 << 261) + P
    y3 = (t2 * z3h + t0m * y3h) / Fraction(1 << 261) + P
    z3 = first * z3h / Fraction(1 << 261) + P
    assert x3 < Fraction(205, 100) * P < 3 * P < 1 << 256
    assert z3 < Fraction(115, 100) * P < 2 * P
    assert y3 < Fraction(78, 10) * P < 1 << 258
    assert t0m < 1 << 261 and y3h < 1 << 261
    # columns: exact limbs below 2^29, lazy ones below 2^29 + 2^7, y3 / 2
    # below 2^30
    exact, lazy, wide = [M29] * 9, [M29 + (1 << 7)] * 9, [(1 << 30) - 1] * 9
    _redc29(_columns([(exact, exact)], square=True))
    _redc29(_columns([(exact, lazy)]))
    _redc29(_columns([(exact, exact), (exact, wide)]))
    # the bias: limbs 0-7 at least 3 * 2^29 (3 t2 limb by limb), value 68 N
    bias = _bias29()
    assert _val29(bias) == 68 * P
    assert min(bias[:8]) >= 3 * M29 and max(bias[:8]) < (1 << 32) - (2 << 29)


def test_radix29_scaling():
    """The 2^-5 of each radix-2^29 product: with the inputs unscaled
    (shift 0) every first product carries 2^-5 where the kernel's carry
    2^3, and each output, two first products deep and one more product,
    ends 2^-16 off the reference; with the kernel's 16 X, 16 Y, 16 Z
    the outputs are exact."""
    for X, Y, Z in _triples(6, 7) + [(FOLD_EDGE[0][0], FOLD_EDGE[0][1],
                                      FOLD_EDGE[1][0])]:
        ref = _reference(X, Y, Z)
        assert double_r29(X, Y, Z) == ref
        off = double_r29(X, Y, Z, shift=0)
        assert tuple(v * (1 << 16) % P for v in off) == ref


def test_bound_counts_the_least_work():
    """chip_smoke.py's count for the doubling: two squarings, six
    products, one reduction fewer for Y3 = t2 z3 + t0m y3 (1,864
    multiply-adds); at 524,288 lanes on a card of 132 SMs at 1,980 MHz
    the bytes (384 a lane at 3.35 TB/s, 0.0601 ms) bound it above the FMA
    pipe (0.0584 ms)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs

    assert cs.OPS_POINT_DOUBLE[0] == 2 * 208 + 6 * 264 - 136 == 1864
    lanes, clk = 524288, 132 * 1980e6
    t_bytes = 2 * 3 * cs.LIMB_BYTES * lanes / cs.HBM_BYTES_PER_S * 1e3
    t_fma = lanes * cs.OPS_POINT_DOUBLE[0] / cs.IMAD_PER_SM_CLK / clk * 1e3
    assert round(t_bytes, 4) == 0.0601 and round(t_fma, 4) == 0.0584
