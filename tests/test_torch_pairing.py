"""PyTorch port, device pairing tower (halo2_verifier_tpu_torch/ops/
pairing.py) on the CPU, piece by piece: its constants, linear maps, Fq2
and Fq12 operations, Frobenius maps and line functions against the JAX
package's pairing_jax on the same seeded inputs, through small jitted JAX
functions, bit for bit (tolerance 0); the tower kernel's constants
against the Python ones; the plain inversion on edge values. The tower
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import pairing_jax as pj
from halo2_verifier_tpu_torch.ops import field as fm
from halo2_verifier_tpu_torch.ops import kernels
from halo2_verifier_tpu_torch.ops import pairing as tp
from halo2_verifier_tpu_torch.ops.constants import FQ_EDGE, P, R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fq(rng, n, edge=()):
    """(16, n) uint32 limbs of canonical Fq values: `edge` first, then
    seeded random ones."""
    vals = list(edge) + [int.from_bytes(rng.bytes(32), "little") % P
                         for _ in range(n - len(edge))]
    return ints_to_limbs(vals).T.copy()


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.uint32))


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _assert_equal(got, want):
    """Port output tree == JAX output tree, leaf for leaf, bit for bit."""
    got, want = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(w).astype(np.int64).astype(np.int32))


def _fq2(rng, n, edge=()):
    return (_fq(rng, n, edge), _fq(rng, n, edge[::-1]))


def _fq12(rng, n):
    return tuple(tuple(_fq2(rng, n) for _ in range(3)) for _ in range(2))


def _map(tree, f):
    if isinstance(tree, tuple):
        return tuple(_map(x, f) for x in tree)
    return f(tree)


def test_constants_match_reference():
    for name in ("_FQ12_MA", "_FQ12_MB", "_FQ12_MC", "_ATE_BITS",
                 "_HARD_BITS"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(pj, name))
    for port, ref in ((tp._G1C, pj._G1C), (tp._G2C, pj._G2C)):
        assert len(port) == len(ref)
        for g, h in zip(port, ref):
            for x, y in zip(g, h):
                np.testing.assert_array_equal(x, np.asarray(y))
    for j in range(3):
        np.testing.assert_array_equal(tp._COND_SUB_LIMBS[j],
                                      pj._COND_SUB_LIMBS[j])
    np.testing.assert_array_equal(tp._C256, pj._C256)
    for row in (8, 252):
        off, k = tp._offset_limbs(row * 65536)
        off_ref, k_ref = pj._offset_limbs(row * 65536)
        np.testing.assert_array_equal(off, off_ref)
        assert k == k_ref


@pytest.mark.parametrize("name", ["_FQ12_MA", "_FQ12_MB", "_FQ12_MC"])
def test_linear_combine_matches_reference(name):
    M = getattr(tp, name)
    rng = np.random.default_rng(len(name) + M.shape[0])
    n_out, k = M.shape
    edge = [0, 1, P - 1, P - 2, (1 << 255) % P]
    X = np.stack([_fq(rng, 5, edge[j % 5:] + edge[:j % 5])
                  for j in range(k)], axis=1)  # (16, k, 5)
    want = jax.jit(lambda x: pj._linear_combine(x, M))(_j(X))
    got = tp.linear_combine_plain(_t(X), M)
    assert got.shape == (16, n_out, 5) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    # and the value: sum_j M[o, j] x_j mod P on Python integers
    xs = [limbs_to_ints(X[:, j].T) for j in range(k)]
    for o in range(n_out):
        assert limbs_to_ints(got[:, o].numpy().T) == [
            sum(int(M[o, j]) * xs[j][i] for j in range(k)) % P
            for i in range(5)]


def test_fq2_mul_many_matches_reference():
    rng = np.random.default_rng(11)
    ps = [(_fq2(rng, 4, (0, P - 1)), _fq2(rng, 4, (P - 1, 1)))
          for _ in range(3)]
    want = jax.jit(pj.fq2_mul_many)(_map(ps, _j))
    _assert_equal(tp.fq2_mul_many(_map(ps, _t)), want)


def test_fq2_inv_matches_reference():
    rng = np.random.default_rng(12)
    a = _fq2(rng, 6, (0, 0, 1, P - 1))  # lane 0 zero (below), lane 1 (0, 1)
    a[1][:, 0] = 0
    want = jax.jit(pj.fq2_inv)(_map(a, _j))
    got = tp.fq2_inv(_map(a, _t))
    _assert_equal(got, want)
    assert int(got[0][:, 0].abs().sum() + got[1][:, 0].abs().sum()) == 0


def test_fq12_mul_matches_reference():
    rng = np.random.default_rng(13)
    a, b = _fq12(rng, 3), _fq12(rng, 3)
    want = jax.jit(pj.fq12_mul)(_map(a, _j), _map(b, _j))
    _assert_equal(tp.fq12_mul(_map(a, _t), _map(b, _t)), want)


def test_fq12_inv_matches_reference():
    rng = np.random.default_rng(14)
    a = _fq12(rng, 2)
    want = jax.jit(pj.fq12_inv)(_map(a, _j))
    _assert_equal(tp.fq12_inv(_map(a, _t)), want)


@pytest.mark.parametrize("name", ["fq12_frobenius", "fq12_frobenius2"])
def test_frobenius_matches_reference(name):
    rng = np.random.default_rng(15 + len(name))
    a = _fq12(rng, 3)
    want = jax.jit(getattr(pj, name))(_map(a, _j))
    _assert_equal(getattr(tp, name)(_map(a, _t)), want)


def test_fq12_conj_matches_reference():
    rng = np.random.default_rng(18)
    a = _fq12(rng, 3)
    want = jax.jit(pj.fq12_conj)(_map(a, _j))
    _assert_equal(tp.fq12_conj(_map(a, _t)), want)


def test_line_functions_match_reference():
    rng = np.random.default_rng(16)
    t = (_fq2(rng, 3), _fq2(rng, 3))
    q = (_fq2(rng, 3), _fq2(rng, 3))
    px, py = _fq(rng, 3), _fq(rng, 3)
    want = jax.jit(pj._line_double)(_map(t, _j), _j(px), _j(py))
    _assert_equal(tp._line_double(_map(t, _t), _t(px), _t(py)), want)
    want = jax.jit(pj._line_add)(_map(t, _j), _map(q, _j), _j(px),
                                 _j(py))
    _assert_equal(tp._line_add(_map(t, _t), _map(q, _t), _t(px), _t(py)),
                  want)


def test_mont_cols_matches_reference():
    vals = FQ_EDGE + [P // 3, 12345]
    np.testing.assert_array_equal(tp.mont_cols(vals),
                                  pj._mont_cols(vals).astype(np.int32))


def _cuda_words(text, name):
    m = re.search(name + r"[^=]*=\s*\{(.*?)\};", text, re.S)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", m.group(1))]


def test_tower_kernel_constants_match_python():
    with open(os.path.join(kernels.CSRC_DIR, "tower.cu")) as f:
        src = f.read()
    words = [[((n - 2) >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
             for n in (P, R)]
    assert _cuda_words(src, "INV_EXP") == words[0] + words[1]
    bits = int(re.search(r"kInvBits = (\d+);", src).group(1))
    assert bits == (P - 2).bit_length() == (R - 2).bit_length()


@pytest.mark.parametrize("spec", [fm.FQ, fm.FR], ids=["fq", "fr"])
def test_plain_inversion_on_edge_values(spec):
    """field.inv_mont on the CPU (the plain version of the inversion
    kernel, the pairing's _finv) on the edge values equals pow on Python
    integers; inv(0) = 0."""
    n = spec.modulus
    rinv = pow(1 << 256, -1, n)
    vals = [v % n for v in FQ_EDGE]
    mont = ints_to_limbs([v * spec.mont_r % n for v in vals])
    got = fm.inv_mont(torch.from_numpy(mont.T.astype(np.int32)), spec)
    assert limbs_to_ints(got.numpy().T) == [
        0 if v == 0 else pow(v, -1, n) * spec.mont_r % n for v in vals]
