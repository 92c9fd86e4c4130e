"""PyTorch port, curve layer (halo2_verifier_tpu_torch/ops/curve.py): the
complete add and double bodies against the JAX package's OPS16 bodies,
projective outputs bit for bit, on random, identity, equal (P+P) and
inverse (P+(-P)) pairs; masked_add with a mask and with gather indices;
to_affine_host against the exact host curve; masked_add on off-curve
triples of the kernels' carry-chain edge values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu.ops import lmcurve as lc
from halo2_verifier_tpu_torch.ops import curve
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, P, fq_edge_triples
from halo2_verifier_tpu_torch.ops.field import FQ
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [jhc.g1_mul(G1_GEN, int(rng.integers(1, 1 << 62)))
            for _ in range(n)]


def _pairs():
    """Pairs covering every case the complete add must absorb."""
    pts = _points(10, 0)
    a, b = pts[0], pts[1]
    cases = [(a, b), (a, a), (a, hc.g1_neg(a)), (a, None), (None, b),
             (None, None)]
    cases += [(pts[i], pts[i + 1]) for i in range(2, 9)]
    return cases


def _mont_affine(points):
    xs = [0 if p is None else p[0] * FQ.mont_r % P for p in points]
    ys = [0 if p is None else p[1] * FQ.mont_r % P for p in points]
    return (np.ascontiguousarray(ints_to_limbs(xs).T),
            np.ascontiguousarray(ints_to_limbs(ys).T))


def _both(points):
    """(JAX projective tuple, torch int32 projective tuple) of the same
    points."""
    x, y = _mont_affine(points)
    jp = lc.from_affine(jnp.asarray(x), jnp.asarray(y))
    tp = curve.from_affine(torch.from_numpy(x.astype(np.int32)),
                           torch.from_numpy(y.astype(np.int32)))
    return jp, tp


def _eq(jax_pt, torch_pt):
    for jc, tc in zip(jax_pt, torch_pt):
        np.testing.assert_array_equal(
            np.asarray(tc).astype(np.int64), np.asarray(jc).astype(np.int64))


def test_from_affine_and_identity_match_reference():
    pts = [a for a, _ in _pairs()] + [None]
    jp, tp = _both(pts)
    _eq(jp, tp)
    _eq(lc.identity(3), curve.identity(3, torch.device("cpu")))
    assert curve.is_identity(tp).tolist() == [p is None for p in pts]


def test_add_body_matches_reference():
    cases = _pairs()
    jp, tp = _both([c[0] for c in cases])
    jq, tq = _both([c[1] for c in cases])
    want = lc.OPS16.add_body(jp, jq)
    got = curve.add(tp, tq)
    _eq(want, got)
    assert curve.to_affine_host(got) == [hc.g1_add(a, b) for a, b in cases]


def test_double_body_matches_reference():
    pts = _points(5, 1) + [None, G1_GEN]
    jp, tp = _both(pts)
    want = lc.OPS16.double_body(jp)
    got = curve.double(tp)
    _eq(want, got)
    assert curve.to_affine_host(got) == [hc.g1_double(p) for p in pts]


def test_masked_add_with_mask_and_indices():
    """mask ? p[:, iL] + q[:, iR] : p[:, iL], against the reference's
    masked_add on the gathered points."""
    pts = _points(8, 2) + [None]
    jp, tp = _both(pts)
    rng = np.random.default_rng(5)
    iL = rng.integers(0, len(pts), size=13).astype(np.int32)
    iR = rng.integers(0, len(pts), size=13).astype(np.int32)
    iR[:3] = iL[:3]  # P + P through the gather
    mask = rng.random(13) < 0.6
    gp = tuple(c[:, iL] for c in jp)
    gq = tuple(c[:, iR] for c in jp)
    want = lc.OPS16.select_point(jnp.asarray(mask),
                                 lc.OPS16.add_body(gp, gq), gp)
    got = curve.masked_add(tp, tp, torch.from_numpy(mask),
                           torch.from_numpy(iL), torch.from_numpy(iR))
    _eq(want, got)
    # without a mask, and with only one side gathered
    got2 = curve.masked_add(tuple(c[:, :9] for c in tp), tp,
                            iR=torch.from_numpy(iR[:9].copy()))
    want2 = lc.OPS16.add_body(tuple(c[:, :9] for c in jp),
                              tuple(c[:, iR[:9]] for c in jp))
    _eq(want2, got2)


def test_to_affine_host_matches_reference():
    pts = _points(4, 3) + [None]
    jp, tp = _both(pts)
    assert curve.to_affine_host(tp) == lc.to_affine_host(
        tuple(np.asarray(c) for c in jp)) == pts



# the lanes whose products multiply FOLD_EDGE pairs, every edge value in
# every coordinate (stride 1), then a second pairing; two chunks of 13
# lanes, the width the tests above already ran the reference's eager body
# at (a new width recompiles each of its ops)
EDGE_LANES = 13
EDGE = fq_edge_triples((1, 7))[:2 * EDGE_LANES]


def edge_chunk(chunk):
    """(P, Q) of one chunk of edge triples as (16, 13) uint32 limb arrays,
    and a mask taking every other lane."""
    lanes = EDGE[EDGE_LANES * chunk:EDGE_LANES * (chunk + 1)]
    cols = [np.ascontiguousarray(ints_to_limbs([t[c] for t in lanes]).T)
            for c in range(6)]
    mask = np.arange(EDGE_LANES) % 2 == chunk
    return tuple(cols[:3]), tuple(cols[3:]), mask


@pytest.mark.parametrize("chunk", [0, 1])
def test_masked_add_on_edge_triples_matches_reference(chunk):
    """The add is plain field arithmetic on any canonical X, Y, Z: the
    port's masked add (the version the card's kernel is held to) equals
    the reference's OPS16 add_body + select on the edge triples."""
    p, q, mask = edge_chunk(chunk)
    jp = tuple(jnp.asarray(c) for c in p)
    jq = tuple(jnp.asarray(c) for c in q)
    want = lc.OPS16.select_point(jnp.asarray(mask),
                                 lc.OPS16.add_body(jp, jq), jp)
    got = curve.masked_add(
        tuple(torch.from_numpy(c.astype(np.int32)) for c in p),
        tuple(torch.from_numpy(c.astype(np.int32)) for c in q),
        torch.from_numpy(mask))
    _eq(want, got)
