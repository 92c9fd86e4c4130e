"""PyTorch port, limb-minor field layer (halo2_verifier_tpu_torch/ops/
field_minor.py) against the JAX package's ops/field_jax.py, mirroring
tests/test_field_jax.py: the same seeded inputs through both, the outputs
bit-equal and equal to Python integers, for Fq and Fr. Covered: add, sub,
neg and the Montgomery round trips on 0, 1, N-1, N-2 and the adversarial
limb patterns; the FOLD_EDGE pairs; inv_mont (inv(0) = 0) and pow_fixed;
two leading batch axes and a (16,) constant broadcast against them; the
private steps (_carry_reduce, _mul_columns, _geq, _sub_limbs,
_cond_sub_modulus); and the layout adapter: ops/field.py's limbs-major
plain bodies reached through to_major/to_minor equal the limb-minor plain
bodies, the CPU's view of what the card computes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import field_jax as fj
from halo2_verifier_tpu_torch import weights
from halo2_verifier_tpu_torch.ops import field as fmaj
from halo2_verifier_tpu_torch.ops import field_minor as fm
from halo2_verifier_tpu_torch.ops.constants import FOLD_EDGE, P, R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread keeps the test workers
    from fighting over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = [(fj.FQ, fm.FQ, P), (fj.FR, fm.FR, R)]
IDS = ["fq", "fr"]
POW_EXPONENT = 0xDEADBEEF12345  # tests/test_field_jax.py test_pow_fixed


def _edges(modulus):
    """0, 1, N-1, N-2 and test_exhaustive_small_products' limb patterns."""
    pats = [0, 1, modulus - 1, modulus - 2, (1 << 255) % modulus,
            int("f" * 60, 16) % modulus, 0xFFFF, 0x10000,
            (1 << 240) % modulus]
    return list(dict.fromkeys(pats))


def _random(modulus, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % modulus
            for _ in range(n)]


def _values(modulus, n, seed):
    """n canonical values: the edges, then seeded random ones."""
    edge = _edges(modulus)
    return edge + _random(modulus, n - len(edge), seed)


def _ref(vals, shape=None):
    """The reference's (..., 16) uint32 limbs."""
    arr = ints_to_limbs(vals)
    return arr if shape is None else arr.reshape(*shape, 16)


def _port(arr):
    return weights.limbs_minor_from_reference(arr, "cpu")


def _ints(arr):
    return limbs_to_ints(np.asarray(arr).reshape(-1, 16))


def _same(jax_out, port_out):
    """Bit-equal limbs (shape included); returns the values."""
    want = np.asarray(jax_out)
    got = weights.limbs_minor_to_reference(port_out)
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    return _ints(got)


def test_reference_limbs_round_trip():
    arr = _ref(_values(P, 15, 0), (3, 5))
    t = _port(arr)
    assert t.dtype == torch.int32 and t.shape == (3, 5, 16)
    back = weights.limbs_minor_to_reference(t)
    assert back.dtype == np.uint32 and np.array_equal(back, arr)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_add_sub_neg(specs):
    jspec, tspec, modulus = specs
    a = _values(modulus, 64, 1)
    b = list(reversed(_values(modulus, 64, 2)))
    A, B = _ref(a), _ref(b)
    got = _same(fj.add(jnp.asarray(A), jnp.asarray(B), jspec),
                fm.add(_port(A), _port(B), tspec))
    assert got == [(x + y) % modulus for x, y in zip(a, b)]
    got = _same(fj.sub(jnp.asarray(A), jnp.asarray(B), jspec),
                fm.sub(_port(A), _port(B), tspec))
    assert got == [(x - y) % modulus for x, y in zip(a, b)]
    got = _same(fj.neg(jnp.asarray(A), jspec), fm.neg(_port(A), tspec))
    assert got == [(-x) % modulus for x in a]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_mont_mul_roundtrip(specs):
    jspec, tspec, modulus = specs
    a = _values(modulus, 64, 3)
    b = list(reversed(_values(modulus, 64, 4)))
    A, B = _ref(a), _ref(b)
    jA, jB = fj.to_mont(jnp.asarray(A), jspec), fj.to_mont(jnp.asarray(B),
                                                           jspec)
    tA, tB = fm.to_mont(_port(A), tspec), fm.to_mont(_port(B), tspec)
    r = tspec.mont_r
    assert _same(jA, tA) == [x * r % modulus for x in a]
    assert _same(jB, tB) == [x * r % modulus for x in b]
    jprod, tprod = fj.mont_mul(jA, jB, jspec), fm.mont_mul(tA, tB, tspec)
    assert _same(jprod, tprod) == [x * y * r % modulus for x, y in zip(a, b)]
    got = _same(fj.from_mont(jprod, jspec), fm.from_mont(tprod, tspec))
    assert got == [x * y % modulus for x, y in zip(a, b)]
    assert _same(fj.from_mont(jA, jspec), fm.from_mont(tA, tspec)) == a
    got = _same(fj.mont_square(jA, jspec), fm.mont_square(tA, tspec))
    assert got == [x * x * r % modulus for x in a]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_exhaustive_small_products(specs):
    """Every pair of the edge values, raw (as Montgomery residues) and
    through to_mont/from_mont."""
    jspec, tspec, modulus = specs
    pats = _edges(modulus)
    pairs = [(x, y) for x in pats for y in pats]
    A = _ref([x for x, _ in pairs])
    B = _ref([y for _, y in pairs])
    rinv = pow(tspec.mont_r, -1, modulus)
    got = _same(fj.mont_mul(jnp.asarray(A), jnp.asarray(B), jspec),
                fm.mont_mul(_port(A), _port(B), tspec))
    assert got == [x * y * rinv % modulus for x, y in pairs]
    jA = fj.to_mont(jnp.asarray(A), jspec)
    jB = fj.to_mont(jnp.asarray(B), jspec)
    got = _same(fj.from_mont(fj.mont_mul(jA, jB, jspec), jspec),
                fm.from_mont(fm.mont_mul(fm.to_mont(_port(A), tspec),
                                         fm.to_mont(_port(B), tspec), tspec),
                             tspec))
    assert got == [x * y % modulus for x, y in pairs]


def test_fold_edge_pairs():
    """ops/constants.py FOLD_EDGE: the Fq pairs at the limbs-major body's
    fold edge, through the limb-minor product."""
    A = _ref([x for x, _ in FOLD_EDGE])
    B = _ref([y for _, y in FOLD_EDGE])
    rinv = pow(fm.FQ.mont_r, -1, P)
    got = _same(fj.mont_mul(jnp.asarray(A), jnp.asarray(B), fj.FQ),
                fm.mont_mul(_port(A), _port(B), fm.FQ))
    assert got == [x * y * rinv % P for x, y in FOLD_EDGE]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_inv_mont(specs):
    jspec, tspec, modulus = specs
    a = _values(modulus, 24, 5)
    A = fj.to_mont(jnp.asarray(_ref(a)), jspec)
    tA = fm.to_mont(_port(_ref(a)), tspec)
    inv = _same(fj.inv_mont(A, jspec), fm.inv_mont(tA, tspec))
    r = tspec.mont_r
    for x, ix in zip(a, inv):
        assert ix == (0 if x == 0 else pow(x, -1, modulus) * r % modulus)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_pow_fixed(specs):
    jspec, tspec, modulus = specs
    a = _values(modulus, 16, 6)
    A = fj.to_mont(jnp.asarray(_ref(a)), jspec)
    tA = fm.to_mont(_port(_ref(a)), tspec)
    r = tspec.mont_r
    for e in (POW_EXPONENT, 0, 1):
        got = _same(fj.pow_fixed(A, e, jspec), fm.pow_fixed(tA, e, tspec))
        assert got == [pow(x, e, modulus) * r % modulus for x in a]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_two_batch_axes_and_constant_broadcast(specs):
    """(3, 5, 16) operands against (5, 16) and (16,) ones."""
    jspec, tspec, modulus = specs
    a = _values(modulus, 15, 7)
    b = _random(modulus, 5, 8)
    c = _random(modulus, 1, 9)[0]
    A, B, C = _ref(a, (3, 5)), _ref(b, (5,)), _ref([c])[0]
    jA, jB, jC = jnp.asarray(A), jnp.asarray(B), jnp.asarray(C)
    tA, tB, tC = _port(A), _port(B), _port(C)
    rinv = pow(tspec.mont_r, -1, modulus)
    bb = b * 3
    got = _same(fj.add(jA, jB, jspec), fm.add(tA, tB, tspec))
    assert got == [(x + y) % modulus for x, y in zip(a, bb)]
    got = _same(fj.sub(jC, jA, jspec), fm.sub(tC, tA, tspec))
    assert got == [(c - x) % modulus for x in a]
    got = _same(fj.mont_mul(jA, jC, jspec), fm.mont_mul(tA, tC, tspec))
    assert got == [x * c * rinv % modulus for x in a]
    got = _same(fj.mont_mul(jC, jA, jspec), fm.mont_mul(tC, tA, tspec))
    assert got == [x * c * rinv % modulus for x in a]
    got = _same(fj.mont_mul(jA, jB, jspec), fm.mont_mul(tA, tB, tspec))
    assert got == [x * y * rinv % modulus for x, y in zip(a, bb)]
    _same(fj.to_mont(jA, jspec), fm.to_mont(tA, tspec))
    _same(fj.from_mont(jA, jspec), fm.from_mont(tA, tspec))
    _same(fj.mont_one(jspec, (3, 5)), fm.mont_one(tspec, (3, 5), "cpu"))


def test_predicates_and_select():
    a = _values(P, 15, 10)
    b = list(a)
    b[3] = (b[3] + 1) % P
    A, B = _ref(a, (3, 5)), _ref(b, (3, 5))
    assert np.array_equal(np.asarray(fj.is_zero(jnp.asarray(A))),
                          fm.is_zero(_port(A)).numpy())
    assert np.array_equal(np.asarray(fj.eq(jnp.asarray(A), jnp.asarray(B))),
                          fm.eq(_port(A), _port(B)).numpy())
    cond = np.random.default_rng(11).random((3, 5)) < 0.5
    _same(fj.select(jnp.asarray(cond), jnp.asarray(A), jnp.asarray(B)),
          fm.select(torch.from_numpy(cond), _port(A), _port(B)))


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_private_steps(specs):
    """The reference's helpers on raw columns and on limb vectors that
    need not be canonical (sums of two, values up to 2N)."""
    jspec, tspec, modulus = specs
    rng = np.random.default_rng(12)
    cols = rng.integers(0, 1 << 22, size=(4, 6, 33), dtype=np.uint32)
    for k in (16, 32):
        jl, jc = fj._carry_reduce(jnp.asarray(cols), k)
        tl, tc = fm._carry_reduce(torch.from_numpy(cols.astype(np.int64)), k)
        assert np.array_equal(np.asarray(jl), tl.numpy())
        assert np.array_equal(np.asarray(jc), tc.numpy())
    x = _ref(_values(modulus, 24, 13), (4, 6)).astype(np.int64)
    y = _ref(_values(modulus, 24, 14), (4, 6)).astype(np.int64)
    # values below 2N: x + N where it fits, for the conditional subtract
    x2 = _ref([v + modulus for v in _values(modulus, 24, 15)], (4, 6))
    tx, ty, tx2 = (torch.from_numpy(v.astype(np.int64)) for v in (x, y, x2))
    jx, jy, jx2 = (jnp.asarray(v.astype(np.uint32)) for v in (x, y, x2))
    for n in (16, 32):
        assert np.array_equal(np.asarray(fj._mul_columns(jx, jy, n)),
                              fm._mul_columns(tx, ty, n).numpy())
    assert np.array_equal(np.asarray(fj._geq(jx, jy)),
                          fm._geq(tx, ty).numpy())
    assert np.array_equal(np.asarray(fj._geq(jx, jx)),
                          fm._geq(tx, tx).numpy())
    jd, jb = fj._sub_limbs(jx, jy)
    td, tb = fm._sub_limbs(tx, ty)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())
    got = fm._cond_sub_modulus(tx2, tspec).numpy()
    assert np.array_equal(np.asarray(fj._cond_sub_modulus(jx2, jspec)), got)
    assert _ints(got) == [v % modulus for v in _ints(x2)]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_layout_adapter_matches_limbs_major_bodies(specs):
    """ops/field.py's limbs-major plain bodies reached through to_major and
    to_minor equal the limb-minor plain bodies: what the card computes
    (K1, T3 and K1's square-and-multiply on the transposed operands), on
    the CPU. A (3, 5, 16) operand against a (16,) constant."""
    _jspec, tspec, modulus = specs
    A = _port(_ref(_values(modulus, 15, 16), (3, 5)))
    C = _port(_ref(_random(modulus, 1, 17))[0])
    shape, (x, c) = fm.to_major(A, C)
    assert shape == (3, 5) and x.shape == (16, 15) and x.is_contiguous()
    assert torch.equal(fm.to_minor(x, shape), A)
    for major, minor in ((fmaj.mont_mul, fm.mont_mul), (fmaj.add, fm.add),
                         (fmaj.sub, fm.sub)):
        assert torch.equal(fm.to_minor(major(x, c, tspec), shape),
                           minor(A, C, tspec))
    assert torch.equal(fm.to_minor(fmaj.neg(x, tspec), shape),
                       fm.neg(A, tspec))
    assert torch.equal(fm.to_minor(fmaj.inv_mont(x, tspec), shape),
                       fm.inv_mont(A, tspec))
    bits = [(POW_EXPONENT >> i) & 1 for i in range(POW_EXPONENT.bit_length())]
    assert torch.equal(
        fm.to_minor(fmaj.pow_bits_body(x.long(), bits, tspec).int(), shape),
        fm.pow_fixed(A, POW_EXPONENT, tspec))
