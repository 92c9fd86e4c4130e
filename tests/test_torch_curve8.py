"""PyTorch port, curve layer on 8-bit limbs (halo2_verifier_tpu_torch/ops/
curve.py, OPS8): the complete add and double bodies, masked_add with
gathers and a mask, from_affine and identity against the JAX package's
lmcurve.OPS8, run eagerly, projective outputs bit for bit (tolerance 0);
to_affine_host on float32 limbs; the two formats against each other
through the host re-limbing pair; masked_add on off-curve triples of the
kernels' carry-chain edge values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu.ops import lmcurve as lc
from halo2_verifier_tpu_torch import weights
from halo2_verifier_tpu_torch.ops import curve
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, P, fq_edge_triples
from halo2_verifier_tpu_torch.ops.field import FQ
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs

OPS8 = curve.OPS8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers for the
    cores."""
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


def _mont_affine16(points):
    xs = [0 if p is None else p[0] * FQ.mont_r % P for p in points]
    ys = [0 if p is None else p[1] * FQ.mont_r % P for p in points]
    return (np.ascontiguousarray(ints_to_limbs(xs).T),
            np.ascontiguousarray(ints_to_limbs(ys).T))


def _both(points):
    """(JAX OPS8 projective tuple, torch OPS8 projective tuple) of the
    same points, from one numpy array each."""
    x16, y16 = _mont_affine16(points)
    x, y = weights.limbs16_to_limbs8(x16), weights.limbs16_to_limbs8(y16)
    jp = lc.OPS8.from_affine(jnp.asarray(x), jnp.asarray(y))
    tp = OPS8.from_affine(torch.from_numpy(x), torch.from_numpy(y))
    return jp, tp


def _eq(jax_pt, torch_pt):
    for jc, tc in zip(jax_pt, torch_pt):
        assert tc.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_from_affine_and_identity_match_reference():
    pts = [a for a, _ in _pairs()] + [None]
    jp, tp = _both(pts)
    _eq(jp, tp)
    _eq(lc.OPS8.identity(3), OPS8.identity(3, torch.device("cpu")))
    assert OPS8.is_identity(tp).tolist() == [p is None for p in pts]


def test_add_body_matches_reference():
    cases = _pairs()
    jp, tp = _both([c[0] for c in cases])
    jq, tq = _both([c[1] for c in cases])
    want = lc.OPS8.add_body(jp, jq)
    got = OPS8.add(tp, tq)
    _eq(want, got)
    assert curve.to_affine_host(got) == [hc.g1_add(a, b) for a, b in cases]


def test_double_body_matches_reference():
    pts = _points(5, 1) + [None, G1_GEN]
    jp, tp = _both(pts)
    want = lc.OPS8.double_body(jp)
    got = OPS8.double_plain(tp)
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
    want = lc.OPS8.masked_add(gp, gq, jnp.asarray(mask))
    got = OPS8.masked_add(tp, tp, torch.from_numpy(mask),
                          torch.from_numpy(iL), torch.from_numpy(iR))
    _eq(want, got)
    # without a mask, and with only one side gathered
    got2 = OPS8.masked_add(tuple(c[:, :9] for c in tp), tp,
                           iR=torch.from_numpy(iR[:9].copy()))
    want2 = lc.OPS8.add(tuple(c[:, :9] for c in jp),
                        tuple(c[:, iR[:9]] for c in jp))
    _eq(want2, got2)


def test_to_affine_host_on_float_limbs_matches_reference():
    pts = _points(4, 3) + [None]
    jp, tp = _both(pts)
    assert curve.to_affine_host(tp) == lc.to_affine_host(
        tuple(np.asarray(c) for c in jp)) == pts


def test_formats_agree_through_relimbing():
    """The same add in both formats: OPS8's projective output is the
    re-limbed OPS16 output, limb for limb (wide enough to take the CPU
    path's blocks)."""
    cases = _pairs()
    reps = 2 * OPS8.CPU_BLOCK // len(cases) + 1
    x16, y16 = _mont_affine16([c[0] for c in cases] * reps)
    u16, v16 = _mont_affine16([c[1] for c in cases] * reps)
    p16 = curve.from_affine(torch.from_numpy(x16.astype(np.int32)),
                            torch.from_numpy(y16.astype(np.int32)))
    q16 = curve.from_affine(torch.from_numpy(u16.astype(np.int32)),
                            torch.from_numpy(v16.astype(np.int32)))
    to8 = weights.limbs16_to_limbs8
    p8 = tuple(torch.from_numpy(to8(c.numpy())) for c in p16)
    q8 = tuple(torch.from_numpy(to8(c.numpy())) for c in q16)
    s16 = curve.add(p16, q16)
    s8 = OPS8.add(p8, q8)
    for c16, c8 in zip(s16, s8):
        np.testing.assert_array_equal(to8(c16.numpy()), c8.numpy())
    d16 = curve.double(tuple(c[:, :13] for c in p16))
    d8 = OPS8.double_plain(tuple(c[:, :13] for c in p8))
    for c16, c8 in zip(d16, d8):
        np.testing.assert_array_equal(weights.limbs8_to_limbs16(c8.numpy()),
                                      c16.numpy())


# as in tests/test_torch_curve.py: the FOLD_EDGE products, every edge
# value in every coordinate, two chunks at the 13-lane width the tests above compiled
EDGE_LANES = 13
EDGE = fq_edge_triples((1, 7))[:2 * EDGE_LANES]


@pytest.mark.parametrize("chunk", [0, 1])
def test_masked_add_on_edge_triples_matches_reference(chunk):
    """The port's f8 masked add (the version the card's kernel is held to)
    equals the reference's OPS8 masked_add on the edge triples."""
    lanes = EDGE[EDGE_LANES * chunk:EDGE_LANES * (chunk + 1)]
    cols = [weights.limbs16_to_limbs8(ints_to_limbs([t[c] for t in lanes]).T)
            for c in range(6)]
    mask = np.arange(EDGE_LANES) % 2 == chunk
    want = lc.OPS8.masked_add(tuple(jnp.asarray(c) for c in cols[:3]),
                              tuple(jnp.asarray(c) for c in cols[3:]),
                              jnp.asarray(mask))
    got = OPS8.masked_add(tuple(torch.from_numpy(c) for c in cols[:3]),
                          tuple(torch.from_numpy(c) for c in cols[3:]),
                          torch.from_numpy(mask))
    _eq(want, got)
