"""PyTorch port, the device pairing's Miller step on the CPU
(halo2_verifier_tpu_torch/ops/pairing.py miller_step_plain and
_miller_step, csrc/tower.cu miller_step_kernel):

- the plain version in both modes against the JAX package's
  pairing_jax._line_double and _line_add on seeded operands and the edge
  lanes (constants.miller_step_edge_lanes), the new point and all 12 line
  coefficients, zeros included, bit for bit (tolerance 0); the addition
  where xt = xq (inv(0) = 0 gives lambda = 0);
- a model of the kernel's own formulas on Python integers (its
  lambda = num conj(den) / norm(den), squares of two products, lambda px
  as two products), equal to the plain version; the inversion inside it is
  T3's chain, whose radix-2^29 arithmetic tests/test_torch_fq12_fused.py
  emulates step by step;
- the Miller loop through _miller_step (64 doublings, 38 additions)
  against the reference's own pieces run in the reference's order, and
  against the host oracle;
- the step's constants in tower.cu (the line's slots, the inversion's
  tables) against Python.

The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import collections
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import pairing_jax as pj
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import hostpairing as hp
from halo2_verifier_tpu_torch.ops import kernels
from halo2_verifier_tpu_torch.ops import pairing as tp
from halo2_verifier_tpu_torch.ops.constants import (
    G1_GEN, G2_GEN, P, miller_step_edge_lanes)
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

LANES = 3  # one shape for every jitted reference function
MONT_R = (1 << 256) % P
RINV = pow(1 << 256, -1, P)
MODES = {"double": kernels.MILLER_DOUBLE, "add": kernels.MILLER_ADD}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jit(name):
    """A pairing_jax function, jitted once for the module."""
    return jax.jit(getattr(pj, name))


def _lanes(seed, edge=()):
    """LANES lanes of 10 canonical values (xt0, xt1, yt0, yt1, xq0, xq1,
    yq0, yq1, px, py): `edge` first, seeded random ones after."""
    rng = np.random.default_rng(seed)
    rand = [tuple(int.from_bytes(rng.bytes(32), "little") % P
                  for _ in range(10)) for _ in range(LANES - len(edge))]
    return list(edge) + rand


def _cols(lanes, c):
    """Coordinate c of every lane as (16, LANES) uint32 limbs."""
    return ints_to_limbs([lane[c] for lane in lanes]).T.copy()


def _torch_args(lanes):
    t = lambda c: torch.from_numpy(_cols(lanes, c).astype(np.int32))
    T = torch.stack([t(c) for c in range(4)], dim=1)
    Q = torch.stack([t(c) for c in range(4, 8)], dim=1)
    return T, Q, (t(8), t(9))


def _reference(mode, lanes):
    """(T', line stack) of pairing_jax's line function, as int32 arrays."""
    j = lambda c: jnp.asarray(_cols(lanes, c))
    t = ((j(0), j(1)), (j(2), j(3)))
    if mode == kernels.MILLER_DOUBLE:
        (x3, y3), line = _jit("_line_double")(t, j(8), j(9))
    else:
        q = ((j(4), j(5)), (j(6), j(7)))
        (x3, y3), line = _jit("_line_add")(t, q, j(8), j(9))
    T = np.stack([np.asarray(v) for v in (*x3, *y3)], axis=1)
    return (T.astype(np.int32),
            np.asarray(pj._fq12_coeff_stack(line)).astype(np.int32))


def _assert_step_matches_reference(mode, lanes):
    T, Q, P_ = _torch_args(lanes)
    got_t, got_line = tp.miller_step_plain(
        mode, T, Q if mode == kernels.MILLER_ADD else None, P_)
    want_t, want_line = _reference(mode, lanes)
    assert got_t.shape == (16, 4, LANES) and got_t.dtype == torch.int32
    assert got_line.shape == (16, 12, LANES)
    assert got_line.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_line.numpy(), want_line)


@pytest.mark.parametrize("mode", MODES.values(), ids=MODES.keys())
def test_miller_step_plain_matches_reference(mode):
    """(a) The plain step on seeded operands and on the edge lanes, in
    groups of LANES, against the reference's line function."""
    edge = miller_step_edge_lanes()
    _assert_step_matches_reference(mode, _lanes(41 + mode))
    for k in range(0, len(edge), LANES):
        group = edge[k:k + LANES]
        _assert_step_matches_reference(mode, _lanes(43 + k, group))


def test_add_step_at_equal_x_matches_reference():
    """(b) The addition where xt = xq (Q = T, Q = -T, and Q = T with both
    at zero): the denominator's inverse is 0 in the reference, so lambda
    is 0, x3 = -xt - xq, y3 = -yt; the plain step gives the same."""
    rng = np.random.default_rng(45)
    t = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(5)]
    lanes = [(t[0], t[1], t[2], t[3], t[0], t[1], t[2], t[3], t[4], 7),
             (t[0], t[1], t[2], t[3], t[0], t[1], (-t[2]) % P,
              (-t[3]) % P, t[4], 9),
             (0, 0, t[2], t[3], 0, 0, t[3], t[2], 0, 0)]
    _assert_step_matches_reference(kernels.MILLER_ADD, lanes)
    T, Q, P_ = _torch_args(lanes)
    got_t, _ = tp.miller_step_plain(kernels.MILLER_ADD, T, Q, P_)
    x3 = limbs_to_ints(got_t[:, 0].numpy().T)
    assert x3 == [(-2 * lane[0]) % P for lane in lanes]


# ------------------------------------ the kernel's formulas on integers


def _mont(a, b):
    return a * b * RINV % P


def _fq2_mul(a, b):  # tower.cu fq2_mul: Karatsuba
    t0, t1 = _mont(a[0], b[0]), _mont(a[1], b[1])
    t2 = _mont((a[0] + a[1]) % P, (b[0] + b[1]) % P)
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def _fq2_sqr(a):  # tower.cu fq2_sqr: (a0 + a1)(a0 - a1), 2 a0 a1
    m = _mont(a[0], a[1])
    return (_mont((a[0] + a[1]) % P, (a[0] - a[1]) % P), 2 * m % P)


def _fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _inv(x):
    """x R -> x^-1 R, inv(0) = 0: what tower.cu inv29 computes."""
    v = x * RINV % P
    return 0 if v == 0 else pow(v, P - 2, P) * MONT_R % P


def _kernel_step(mode, lane):
    """tower.cu miller_step_kernel's formulas, in its order, on one lane
    of Montgomery residues: (T' as 4 ints, the line's 12 coefficients)."""
    xt, yt, xq, yq = lane[0:2], lane[2:4], lane[4:6], lane[6:8]
    px, py = lane[8], lane[9]
    if mode == kernels.MILLER_ADD:
        num, den = _fq2_sub(yt, yq), _fq2_sub(xt, xq)
    else:
        s = _fq2_sqr(xt)
        num = tuple(3 * c % P for c in s)
        den = tuple(2 * c % P for c in yt)
    norm = (_mont(den[0], den[0]) + _mont(den[1], den[1])) % P
    w = _fq2_mul(num, (den[0], -den[1] % P))
    ninv = _inv(norm)
    lam = (_mont(w[0], ninv), _mont(w[1], ninv))
    ll = _fq2_sqr(lam)
    if mode == kernels.MILLER_ADD:
        x3 = _fq2_sub(_fq2_sub(ll, xt), xq)
        c4 = _fq2_sub(_fq2_mul(lam, xq), yq)
    else:
        x3 = _fq2_sub(ll, tuple(2 * c % P for c in xt))
        c4 = _fq2_sub(_fq2_mul(lam, xt), yt)
    y3 = _fq2_sub(_fq2_mul(lam, _fq2_sub(xt, x3)), yt)
    c3 = tuple(-_mont(c, px) % P for c in lam)
    line = [0] * 12
    line[tp._LINE_PY] = py
    line[tp._LINE_C3:tp._LINE_C3 + 2] = c3
    line[tp._LINE_C4:tp._LINE_C4 + 2] = c4
    return list(x3 + y3), line


@pytest.mark.parametrize("mode", MODES.values(), ids=MODES.keys())
def test_kernel_formulas_match_plain(mode):
    """(c) The kernel's formulas on Python integers equal the plain step
    (the reference's composition) on the edge lanes and seeded ones."""
    lanes = miller_step_edge_lanes() + _lanes(47, ())
    T, Q, P_ = _torch_args(lanes)
    got_t, got_line = tp.miller_step_plain(
        mode, T, Q if mode == kernels.MILLER_ADD else None, P_)
    for i, lane in enumerate(lanes):
        want_t, want_line = _kernel_step(mode, lane)
        assert limbs_to_ints(got_t[:, :, i].numpy().T) == want_t, i
        assert limbs_to_ints(got_line[:, :, i].numpy().T) == want_line, i


# ------------------------------------------------------ the Miller loop


def _reference_miller_lanes(g1, g2):
    """pairing_jax.miller_loop_lanes' steps in its order, each piece a
    jitted pairing_jax function (the scan's body run on the host)."""
    px, py = jnp.asarray(g1[0]), jnp.asarray(g1[1])
    q = ((jnp.asarray(g2[0]), jnp.asarray(g2[1])),
         (jnp.asarray(g2[2]), jnp.asarray(g2[3])))
    f, t = pj.fq12_one(g1.shape[2]), q
    for bit in pj._ATE_BITS:
        f = _jit("fq12_square")(f)
        t, line = _jit("_line_double")(t, px, py)
        f = _jit("fq12_mul")(f, line)
        if bit:
            t, line = _jit("_line_add")(t, q, px, py)
            f = _jit("fq12_mul")(f, line)
    q1 = _jit("_g2_frobenius_twist")(q)
    q2 = _jit("_g2_frobenius_twist")(q1)
    q2 = (q2[0], pj.fq2_neg(q2[1]))
    t, line = _jit("_line_add")(t, q1, px, py)
    f = _jit("fq12_mul")(f, line)
    _, line = _jit("_line_add")(t, q2, px, py)
    return np.asarray(pj.fq12_stack(_jit("fq12_mul")(f, line)))


def test_miller_loop_through_steps_matches_reference(monkeypatch):
    """(d) miller_loop_lanes on the CPU runs every step through
    _miller_step (64 doublings, 38 additions per loop) and its lanes equal
    the reference's and the host oracle's."""
    pairs = [(hc.g1_mul(G1_GEN, 3), hc.g2_mul(G2_GEN, 5)),
             (hc.g1_mul(G1_GEN, 7), hc.g2_mul(G2_GEN, 11)),
             (G1_GEN, G2_GEN)]
    g1 = np.stack([tp.mont_cols([p[i] for p, _ in pairs]) for i in (0, 1)])
    g2 = np.stack([tp.mont_cols([q[i][j] for _, q in pairs])
                   for i in (0, 1) for j in (0, 1)])
    steps = collections.Counter()
    step = tp._miller_step

    def counted(mode, *args):
        steps[mode] += 1
        return step(mode, *args)

    monkeypatch.setattr(tp, "_miller_step", counted)
    got = tp.miller_lanes(torch.from_numpy(g1), torch.from_numpy(g2))
    assert dict(steps) == {kernels.MILLER_DOUBLE: 64, kernels.MILLER_ADD: 38}
    want = _reference_miller_lanes(g1.astype(np.uint32),
                                   g2.astype(np.uint32))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    for i, (p, q) in enumerate(pairs):
        assert tp.fq12_from_device(got, lane=i) == hp.miller_loop(p, q)


# -------------------------------------------------------- the constants


def _source():
    with open(os.path.join(kernels.CSRC_DIR, "tower.cu")) as f:
        return f.read()


def _c_words(text, name):
    m = re.search(re.escape(name) + r"(?:\[\d+\])+\s*=\s*\{(.*?)\};", text,
                  re.S)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", m.group(1))]


def test_step_constants_match_python():
    """(e) The line's slots in tower.cu and ops/pairing.py are where the
    reference's _sparse_line puts py, c3 and c4 in its coefficient stack;
    the step runs T3's inversion (inv29 on INV_IN29, INV_EXP, INV_OUT29,
    whose values are N - 2, 2^266 and 2^256 mod N in radix 2^29) with
    T3's window; the mode is a template parameter."""
    src = _source()
    slots = {k: int(re.search(k + r" = (\d+)", src).group(1))
             for k in ("kLinePy", "kLineC3", "kLineC4")}
    assert (slots["kLinePy"], slots["kLineC3"], slots["kLineC4"]) == (
        tp._LINE_PY, tp._LINE_C3, tp._LINE_C4)
    mark = lambda v: jnp.full((16, 1), v, dtype=jnp.uint32)
    stack = np.asarray(pj._fq12_coeff_stack(pj._sparse_line(
        mark(1), (mark(2), mark(3)), (mark(4), mark(5)), 1)))[0, :, 0]
    assert list(stack) == [1, 0, 0, 0, 0, 0, 2, 3, 4, 5, 0, 0]
    assert [tp._LINE_PY, tp._LINE_C3, tp._LINE_C4] == [
        int(np.flatnonzero(stack == v)[0]) for v in (1, 2, 4)]
    assert "inv29<0, InvShape::kWindow>(norm)" in src
    assert _c_words(src, "INV_EXP")[:8] == [
        ((P - 2) >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    m29 = (1 << 29) - 1
    assert _c_words(src, "INV_IN29")[:9] == [
        ((1 << 266) % P >> (29 * j)) & m29 for j in range(9)]
    assert _c_words(src, "INV_OUT29")[:9] == [
        ((1 << 256) % P >> (29 * j)) & m29 for j in range(9)]
    assert re.search(r"kModeTemplate = true;", src)
