"""PyTorch port, limb-minor G1 layer (halo2_verifier_tpu_torch/ops/
curve_minor.py) against the JAX package's ops/curve_jax.py, mirroring
tests/test_curve_msm_jax.py: the same points through both, the projective
outputs bit-equal and the affine ones equal to the host curve
(ops/hostcurve.py, Python integers). Covered: the six complete-add cases
(generic, P+P, P+(-P), the identity on either side, both identities), the
doubling of the identity and of generic points, to_affine_batch of the
identity, from_affine, identity, select_point and is_identity, points with
two leading batch axes; and the layout adapter: ops/curve.py's
limbs-major plain bodies (the bodies K2 and K3 are held to) reached
through to_major/to_minor equal the limb-minor plain bodies."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import curve_jax as cj
from halo2_verifier_tpu.ops import field_jax as fj
from halo2_verifier_tpu_torch import weights
from halo2_verifier_tpu_torch.ops import curve as cmaj
from halo2_verifier_tpu_torch.ops import curve_minor as cm
from halo2_verifier_tpu_torch.ops import field_minor as fm
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, P
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mont_xy(points):
    """Affine points (None = infinity) -> the reference's Montgomery
    (x, y) limb arrays, (0, 0) for infinity."""
    r = fm.FQ.mont_r
    xs = [0 if p is None else p[0] * r % P for p in points]
    ys = [0 if p is None else p[1] * r % P for p in points]
    return ints_to_limbs(xs), ints_to_limbs(ys)


def _both(points, shape=None):
    """The projective points in the reference (jnp) and in the port."""
    x, y = _mont_xy(points)
    if shape is not None:
        x, y = x.reshape(*shape, 16), y.reshape(*shape, 16)
    port = cm.from_affine(weights.limbs_minor_from_reference(x, "cpu"),
                          weights.limbs_minor_from_reference(y, "cpu"))
    return cj.from_affine(jnp.asarray(x), jnp.asarray(y)), port


def _same_point(jp, tp):
    for jc, tc in zip(jp, tp):
        want = np.asarray(jc)
        got = weights.limbs_minor_to_reference(tc)
        assert got.shape == want.shape and np.array_equal(got, want)


def _affine(pt):
    """The port's to_affine_batch as host points."""
    x, y = cm.to_affine_batch(pt)
    rinv = pow(fm.FQ.mont_r, -1, P)
    xs = limbs_to_ints(x.reshape(-1, 16).numpy())
    ys = limbs_to_ints(y.reshape(-1, 16).numpy())
    return [None if (a == 0 and b == 0) else (a * rinv % P, b * rinv % P)
            for a, b in zip(xs, ys)]


def test_complete_add_cases():
    a = hc.g1_mul(G1_GEN, 123)
    b = hc.g1_mul(G1_GEN, 456)
    cases = [(a, b), (a, a), (a, hc.g1_neg(a)), (a, None), (None, b),
             (None, None)]
    jp, tp = _both([c[0] for c in cases])
    jq, tq = _both([c[1] for c in cases])
    jr, tr = cj.add(jp, jq), cm.add(tp, tq)
    _same_point(jr, tr)
    _same_point(cj.to_affine_batch(jr), cm.to_affine_batch(tr))
    assert _affine(tr) == [hc.g1_add(x, y) for x, y in cases]


def test_complete_double():
    pts = [G1_GEN, hc.g1_mul(G1_GEN, 789), None]
    jp, tp = _both(pts)
    jr, tr = cj.double(jp), cm.double(tp)
    _same_point(jr, tr)
    _same_point(cj.to_affine_batch(jr), cm.to_affine_batch(tr))
    assert _affine(tr) == [hc.g1_double(p) for p in pts]


def test_identity_and_predicates():
    jid, tid = cj.identity((2, 3)), cm.identity((2, 3), "cpu")
    _same_point(jid, tid)
    assert bool(cm.is_identity(tid).all())
    x, y = cm.to_affine_batch(tid)
    assert not x.any() and not y.any()
    _same_point(cj.to_affine_batch(jid), (x, y))
    pts = [G1_GEN, None, hc.g1_mul(G1_GEN, 5), None]
    jp, tp = _both(pts)
    assert np.array_equal(np.asarray(cj.is_identity(jp)),
                          cm.is_identity(tp).numpy())
    assert cm.is_identity(tp).tolist() == [p is None for p in pts]
    cond = np.array([True, False, False, True])
    jq, tq = _both([hc.g1_mul(G1_GEN, 7 + k) for k in range(4)])
    _same_point(cj.select_point(jnp.asarray(cond), jp, jq),
                cm.select_point(torch.from_numpy(cond), tp, tq))


def test_two_batch_axes():
    """(2, 3) batches of points: add, double and the affine map against
    the reference and the host curve."""
    rng = np.random.default_rng(21)
    ks = [int(k) for k in rng.integers(1, 1 << 40, size=12)]
    ps = [hc.g1_mul(G1_GEN, k) for k in ks[:6]]
    qs = [hc.g1_mul(G1_GEN, k) for k in ks[6:]]
    qs[1], qs[4] = ps[1], hc.g1_neg(ps[4])
    ps[2] = None
    jp, tp = _both(ps, (2, 3))
    jq, tq = _both(qs, (2, 3))
    jr, tr = cj.add(jp, jq), cm.add(tp, tq)
    _same_point(jr, tr)
    assert tr[0].shape == (2, 3, 16)
    assert _affine(tr) == [hc.g1_add(p, q) for p, q in zip(ps, qs)]
    jd, td = cj.double(jr), cm.double(tr)
    _same_point(jd, td)
    assert _affine(td) == [hc.g1_double(hc.g1_add(p, q))
                           for p, q in zip(ps, qs)]


def test_layout_adapter_matches_limbs_major_bodies():
    """ops/curve.py's limbs-major bodies (add through masked_add_plain,
    double_plain: the plain versions K2 and K3 are held to) reached
    through to_major/to_minor equal curve_minor's plain add and double on
    (2, 3) batches, projective outputs included."""
    ks = [3, 5, 8, 13, 21, 34]
    ps = [hc.g1_mul(G1_GEN, k) for k in ks]
    qs = [ps[0], hc.g1_neg(ps[1]), None, hc.g1_mul(G1_GEN, 99), None, G1_GEN]
    ps[4] = None
    _jp, tp = _both(ps, (2, 3))
    _jq, tq = _both(qs, (2, 3))
    tr = cm.add(tp, tq)
    shape, cs = fm.to_major(*tp, *tq)
    major = cmaj.add(tuple(cs[:3]), tuple(cs[3:]))
    for got, want in zip(major, tr):
        assert torch.equal(fm.to_minor(got, shape), want)
    shape, cs = fm.to_major(*tr)
    for got, want in zip(cmaj.double(tuple(cs)), cm.double(tr)):
        assert torch.equal(fm.to_minor(got, shape), want)
    shape, cs = fm.to_major(*tr)
    assert cmaj.to_affine_host(cs) == _affine(tr)
