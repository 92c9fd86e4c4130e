"""PyTorch port, the device pairing's fused Fq12 multiply and radix-2^29
inversion on the CPU (halo2_verifier_tpu_torch/ops/pairing.py,
csrc/tower.cu, csrc/linmap.cuh, csrc/mont29.cuh):

- the Fq12 multiply and square on the coefficient-stack layout, and the
  hard part's exponentiation over stacks, against the JAX package's
  pairing_jax on seeded inputs and the edge pairs, bit for bit
  (tolerance 0);
- the kernels' constant tables (the maps' nonzeros, the radix-2^29 and
  linear-map constants) against the Python-derived values;
- the kernels' integer arithmetic, step for step on Python integers (each
  64-bit column checked against its range): the linear maps' column sums
  and single reduction, the fused multiply's schedule over its tables,
  and the inversion's windowed radix-2^29 chain for Fq and Fr;
- the kernel launches one device pairing check dispatches, counted
  through the dispatch on the plain versions.

The kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import collections
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import pairing_jax as pj
from halo2_verifier_tpu_torch.ops import decomp
from halo2_verifier_tpu_torch.ops import field as fm
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import kernels
from halo2_verifier_tpu_torch.ops import pairing as tp
from halo2_verifier_tpu_torch.ops.constants import (
    FOLD_EDGE, G1_GEN, G2_GEN, P, R, fq12_edge_pairs)
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

M32 = (1 << 32) - 1
M29 = (1 << 29) - 1
RINV = pow(1 << 256, -1, P)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source(name):
    with open(os.path.join(kernels.CSRC_DIR, name)) as f:
        return f.read()


def _c_table(text, name):
    """The integers of the C array `name` (decimal, any sign)."""
    m = re.search(re.escape(name) + r"(?:\[\d+\])+\s*=\s*\{(.*?)\};", text,
                  re.S)
    return [int(v) for v in re.findall(r"-?\d+", m.group(1))]


def _c_words(text, name):
    """The 0x...u words of the C array `name`."""
    m = re.search(re.escape(name) + r"(?:\[\d+\])+\s*=\s*\{(.*?)\};", text,
                  re.S)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", m.group(1))]


def _words(v, n=8):
    return [(v >> (32 * j)) & M32 for j in range(n)]


def _limbs29(v):
    return [(v >> (29 * j)) & M29 for j in range(9)]


# ---------------------------------------------------------- operands


def _stacks(width, seed):
    """(a, b): (16, 12, width) uint32 limb stacks, the edge pairs
    (constants.fq12_edge_pairs) in the first lanes, seeded random
    canonical values after, plus the values as ints [coef][lane]."""
    pairs = fq12_edge_pairs()[:width]
    rng = np.random.default_rng(seed)
    out = []
    for side in (0, 1):
        vals = [[p[side][c] for p in pairs]
                + [int.from_bytes(rng.bytes(32), "little") % P
                   for _ in range(width - len(pairs))] for c in range(12)]
        limbs = np.stack([ints_to_limbs(v).T for v in vals], axis=1)
        out.append((limbs.astype(np.uint32), vals))
    return out


def _tree(X):
    """A (16, 12, B) stack -> the reference's Fq12 tuple tree of (16, B)
    jax arrays."""
    c = [jnp.asarray(X[:, i]) for i in range(12)]
    return (((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
            ((c[6], c[7]), (c[8], c[9]), (c[10], c[11])))


def _stacked(tree):
    return np.asarray(pj._fq12_coeff_stack(tree)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


@pytest.mark.parametrize("square", [False, True], ids=["mul", "square"])
def test_fq12_mul_stack_matches_reference(square):
    """fq12_mul_stack (on the CPU: fq12_mul_plain) equals
    pairing_jax.fq12_mul / fq12_square on the edge pairs and seeded
    random stacks; fq12_mul and fq12_square on tuple trees agree."""
    (a, _), (b, _) = _stacks(29, 31)
    if square:
        want = jax.jit(pj.fq12_square)(_tree(a))
        got = tp.fq12_mul_stack(_t(a), _t(a))
        tree = tp.fq12_square(tp._fq12_from_stack(_t(a)))
    else:
        want = jax.jit(pj.fq12_mul)(_tree(a), _tree(b))
        got = tp.fq12_mul_stack(_t(a), _t(b))
        tree = tp.fq12_mul(tp._fq12_from_stack(_t(a)),
                           tp._fq12_from_stack(_t(b)))
    assert got.shape == (16, 12, 29) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _stacked(want))
    np.testing.assert_array_equal(tp._fq12_coeff_stack(tree).numpy(),
                                  got.numpy())


def test_fq12_pow_bits_on_stacks_matches_reference():
    """The hard part's loop (stacked on entry, split on exit) over a
    short bit array, against pairing_jax.fq12_pow_bits."""
    (a, _), _ = _stacks(24, 32)
    bits = np.asarray([1, 0, 1, 1, 0, 0, 1], dtype=np.int32)
    want = jax.jit(lambda x: pj.fq12_pow_bits(x, bits))(_tree(a))
    got = tp.fq12_pow_bits(tp._fq12_from_stack(_t(a)), bits)
    np.testing.assert_array_equal(tp._fq12_coeff_stack(got).numpy(),
                                  _stacked(want))


# ------------------------------------------------------ kernel tables


def _csr(text, prefix, n_in, coefs=True):
    rows = _c_table(text, prefix + "_ROW")
    cols = _c_table(text, prefix + "_COL")
    vals = _c_table(text, prefix + "_COEF") if coefs else [1] * len(cols)
    n_out = next(i for i in range(1, len(rows)) if rows[i] == len(cols))
    M = np.zeros((n_out, n_in), dtype=np.int64)
    for o in range(n_out):
        for k in range(rows[o], rows[o + 1]):
            M[o, cols[k]] = vals[k]
    return M, rows, cols, vals


def test_fq12_map_tables_match_derivation():
    """tower.cu's nonzero tables rebuild _derive_fq12_mul_maps(): MA and
    MB are one map of 0/1 coefficients (FQ12_MAB), MC has its own signed
    coefficients; every row sum of |c| is within linmap.cuh's bound."""
    src = _source("tower.cu")
    MA, MB, MC = tp._derive_fq12_mul_maps()
    assert set(np.unique(MA)) <= {0, 1} and (MA == MB).all()
    mab, rows, cols, _ = _csr(src, "FQ12_MAB", 12, coefs=False)
    np.testing.assert_array_equal(mab, MA)
    assert len(cols) == int((MA != 0).sum()) and rows[54] == len(cols)
    mc, rows, cols, vals = _csr(src, "FQ12_MC", 54)
    np.testing.assert_array_equal(mc, MC)
    assert 0 not in vals and rows[12] == len(cols) == 324
    assert max(np.abs(MC).sum(axis=1)) <= 256


def test_radix29_and_linmap_constants_match_python():
    """mont29.cuh's moduli in radix 2^29 and -N^-1 mod 2^29, tower.cu's
    conversion constants into and out of R' = 2^261 and its exponents,
    linmap.cuh's offset 256 N and quotient divisor, for Fq and Fr."""
    m29 = _source("mont29.cuh")
    tower = _source("tower.cu")
    lin = _source("linmap.cuh")
    mods = (P, R)
    assert _c_words(m29, "MOD29") == _limbs29(P) + _limbs29(R)
    assert _c_words(m29, "NINV29") == [
        (-pow(n, -1, 1 << 29)) % (1 << 29) for n in mods]
    assert _c_words(tower, "INV_IN29") == sum(
        (_limbs29((1 << 266) % n) for n in mods), [])
    assert _c_words(tower, "INV_OUT29") == sum(
        (_limbs29((1 << 256) % n) for n in mods), [])
    assert _c_words(tower, "INV_EXP") == _words(P - 2) + _words(R - 2)
    assert _c_words(lin, "LIN_OFFSET") == _words(256 * P, 9) + _words(
        256 * R, 9)
    top = int(re.search(r"kLinTopPlus1 = 0x([0-9a-f]+)ull;", lin).group(1),
              16)
    assert top == (P >> 224) + 1 == (R >> 224) + 1
    window = int(re.search(r"kWindow = (\d+);", tower).group(1))
    assert decomp.window_chain_counts(P - 2, window) == (253, 71)


# ------------------------------------------ the kernels' arithmetic


def _col(v, lo=0, hi=1 << 64):
    assert lo <= v < hi
    return v


def _lin_mac(d, c, x):
    """linmap.cuh lin_mac: signed columns, each below 2^40 in magnitude."""
    for j, w in enumerate(_words(x)):
        d[j] = _col(d[j] + c * w, -(1 << 40), 1 << 40)


def _lin_reduce(d, n):
    """linmap.cuh lin_reduce on signed columns d, modulus n."""
    off = _words(256 * n, 9)
    w, carry = [], 0
    for j in range(8):
        v = _col(d[j] + off[j] + carry, -(1 << 63), 1 << 63)
        w.append(v & M32)
        carry = v >> 32
    w.append(_col(carry + off[8], 0, 1 << 32))
    q = ((w[8] << 32) | w[7]) // ((n >> 224) + 1)
    r, carry = [], 0
    for j, nw in enumerate(_words(n)):
        v = _col(w[j] - q * nw + carry, -(1 << 63), 1 << 63)
        r.append(v & M32)
        carry = v >> 32
    assert carry + w[8] == 0
    val = sum(v << (32 * j) for j, v in enumerate(r))
    assert val < 2 * n
    return val - n if val >= n else val


def _lin_combine(coefs_xs, n):
    d = [0] * 8
    for c, x in coefs_xs:
        _lin_mac(d, c, x)
    return _lin_reduce(d, n)


@pytest.mark.parametrize("n", [P, R], ids=["fq", "fr"])
def test_linear_map_arithmetic_emulation(n):
    """The column sums and the one reduction on Python integers, at the
    bound's extremes (256 x (N - 1) positive or negative, MC's rows on
    N - 1) and on seeded values: the residue of the exact sum."""
    rng = np.random.default_rng(33)
    cases = [[(256, n - 1)], [(-256, n - 1)], [(128, n - 1), (-128, 1)],
             [(-1, 0)], [(3, n - 2), (-1, n - 1)]]
    for row in tp._FQ12_MC:
        cases.append([(int(c), n - 1) for c in row if c])
        cases.append([(int(c), n - 1 if c < 0 else 0) for c in row if c])
    for _ in range(50):
        k = int(rng.integers(1, 40))
        cs = rng.integers(-10, 11, size=k)
        cases.append([(int(c), int.from_bytes(rng.bytes(32), "little") % n)
                      for c in cs if c])
    for case in cases:
        assert _lin_combine(case, n) == sum(c * x for c, x in case) % n


def test_fused_schedule_emulation():
    """The fused kernel's schedule on Python integers, from tower.cu's
    tables: per lane the 54 operand rows of MA and MB summed and
    reduced, the Montgomery products, MC's outputs in kSplit runs of
    their nonzeros combined and reduced once; equal to fq12_mul_plain on
    the edge pairs and seeded lanes."""
    src = _source("tower.cu")
    split = int(re.search(r"kSplit = (\d+);", src).group(1))
    _, mab_rows, mab_cols, _ = _csr(src, "FQ12_MAB", 12, coefs=False)
    _, mc_rows, mc_cols, mc_vals = _csr(src, "FQ12_MC", 54)
    (a, av), (b, bv) = _stacks(24, 34)
    want = tp.fq12_mul_plain(_t(a), _t(b)).numpy()
    for lane in range(24):
        xa = [av[c][lane] for c in range(12)]
        xb = [bv[c][lane] for c in range(12)]
        prods = []
        for r in range(54):
            run = range(mab_rows[r], mab_rows[r + 1])
            x = _lin_combine([(1, xa[mab_cols[k]]) for k in run], P)
            y = _lin_combine([(1, xb[mab_cols[k]]) for k in run], P)
            prods.append(x * y * RINV % P)
        for o in range(12):
            r0, cnt = mc_rows[o], mc_rows[o + 1] - mc_rows[o]
            d = [0] * 8
            for part in range(split):
                dp = [0] * 8
                for k in range(r0 + part * cnt // split,
                               r0 + (part + 1) * cnt // split):
                    _lin_mac(dp, mc_vals[k], prods[mc_cols[k]])
                d = [_col(s + p, -(1 << 40), 1 << 40)
                     for s, p in zip(d, dp)]
            assert _lin_reduce(d, P) == limbs_to_ints(
                want[:, o, lane:lane + 1].T)[0]


def _redc29(t, n):
    q29 = _limbs29(n)
    ninv = (-pow(n, -1, 1 << 29)) % (1 << 29)
    t = list(t)
    for i in range(9):
        m = ((t[i] & M32) * ninv) & M29
        for j in range(9):
            t[i + j] = _col(t[i + j] + m * q29[j])
        t[i + 1] = _col(t[i + 1] + (t[i] >> 29))
    c = t[9:]
    u = ([c[0] & M29] + [(c[j] & M29) + (c[j - 1] >> 29) for j in range(1, 8)]
         + [c[7] >> 29])
    return ([u[0]] + [(u[j] & M29) + (u[j - 1] >> 29) for j in range(1, 8)]
            + [u[8] + (u[7] >> 29)])


def _value29(limbs):
    return sum(v << (29 * j) for j, v in enumerate(limbs))


def _mul29(a, b, n):
    t = [0] * 17
    if a is b:  # sqr29: cross products doubled
        for i in range(9):
            for j in range(i + 1, 9):
                t[i + j] = _col(t[i + j] + (a[i] << 1) * a[j])
            t[2 * i] = _col(t[2 * i] + a[i] * a[i])
    else:
        for i in range(9):
            for j in range(9):
                t[i + j] = _col(t[i + j] + a[i] * b[j])
    r = _redc29(t, n)
    assert max(r) < (1 << 29) + (1 << 7) and _value29(r) < 2 * n
    return r


def _normalize29(a):
    r, c = [], 0
    for v in a[:8]:
        r.append((v + c) & M29)
        c = (v + c) >> 29
    return r + [a[8] + c]


def _inv29(x, n, window):
    """tower.cu fq_inv_kernel on Python integers: x (Montgomery, R =
    2^256) into R' = 2^261, the window chain over N - 2, back to R."""
    counts = collections.Counter()

    def mul(a, b):
        counts["sq" if a is b else "mul"] += 1
        return _mul29(a, b, n)

    r = mul(_limbs29(x), _limbs29((1 << 266) % n))
    r = decomp.pow_window(r, n - 2, window, mul)
    out = _value29(_normalize29(mul(r, _limbs29((1 << 256) % n))))
    assert out < 2 * n
    return (out - n if out >= n else out), counts


@pytest.mark.parametrize("spec", [fm.FQ, fm.FR], ids=["fq", "fr"])
def test_inversion_radix29_emulation(spec):
    """The inversion's chain (3-bit window, and the 4-bit one of the
    sweep) on 0, 1, N - 1, N - 2, the FOLD_EDGE values and seeded ones:
    the Montgomery inverse x^-1 R mod N (inv(0) = 0), no column past
    2^64; the window's chain (for Fq 253 squarings and 71 products)
    and the two conversions."""
    n, rm = spec.modulus, spec.mont_r
    rng = np.random.default_rng(35)
    xs = [0, 1, n - 1, n - 2] + [v % n for pair in FOLD_EDGE for v in pair]
    xs += [int.from_bytes(rng.bytes(32), "little") % n for _ in range(2)]
    for window in (3, 4):
        for x in xs:
            got, counts = _inv29(x, n, window)
            v = x * pow(rm, -1, n) % n
            assert got == (0 if v == 0 else pow(v, -1, n) * rm % n), x
    _, counts = _inv29(5, n, 3)
    sq, mu = decomp.window_chain_counts(n - 2, 3)
    assert (counts["sq"], counts["mul"]) == (sq, mu + 2)


# -------------------------------------------------- launches per check


def test_dispatch_counts_per_check(monkeypatch):
    """One device pairing check of two live pairs, on the CPU, counted at
    the dispatch points that launch one kernel each on the card: 1,318
    fused Fq12 multiplies (166 in the Miller loop, 2 in the easy part, 1
    for the lane product, 389 + 760 in the hard part), 102 Miller steps
    (64 doublings, 38 additions), 13 K1, 501 T1 and 1 T3 (the final
    exponentiation and the twist; the steps' own arithmetic runs on the
    plain bodies, which no dispatch point counts)."""
    counts = collections.Counter()

    def counted(mod, name, kernel):
        fn = getattr(mod, name)

        def wrapper(*args, **kw):
            counts[kernel] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(tp, "fq12_mul_stack", "fq12_mul")
    counted(tp, "_finv", "fq_inv")
    counted(tp, "_miller_step", "miller_step")
    for name in ("_fadd", "_fsub", "_fneg"):
        counted(tp, name, "fq_addsub")
    counted(fm, "mont_mul", "mont_mul")
    good = [(hc.g1_mul(G1_GEN, 6), hc.g2_mul(G2_GEN, 13)),
            (hc.g1_neg(hc.g1_mul(G1_GEN, 78)), G2_GEN)]
    assert tp.pairing_check_device(good, torch.device("cpu")) is True
    assert dict(counts) == {"fq12_mul": 1318, "miller_step": 102,
                            "mont_mul": 13, "fq_addsub": 501, "fq_inv": 1}
    hard = int(tp._HARD_BITS.sum()) + len(tp._HARD_BITS) - 1
    assert hard == 389 + 760
    steps = len(tp._ATE_BITS) + int(tp._ATE_BITS.sum()) + 2
    assert steps == 102 and len(tp._ATE_BITS) == 64
    miller = 2 * len(tp._ATE_BITS) + int(tp._ATE_BITS.sum()) + 2
    assert miller == 166 and miller + 2 + 1 + hard == 1318
