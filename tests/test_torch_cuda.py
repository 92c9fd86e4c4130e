"""PyTorch port on the card: each Hopper kernel against its plain version,
bit for bit, and a small end-to-end batch. Every test needs a CUDA card
and skips without one. This file imports neither jax nor the JAX package,
so it runs on a machine that has neither; there, skip the repository's
conftest (it imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from halo2_verifier_tpu_torch import weights
from halo2_verifier_tpu_torch.ops import curve, decomp, field as fm
from halo2_verifier_tpu_torch.ops import curve_minor as cmin
from halo2_verifier_tpu_torch.ops import field_minor as fmin
from halo2_verifier_tpu_torch.ops import field8 as f8
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import hostpairing as hp
from halo2_verifier_tpu_torch.ops import kernels, msm_forest, msm_scan
from halo2_verifier_tpu_torch.ops import pairing as tp
from halo2_verifier_tpu_torch.ops.constants import (
    FOLD_EDGE, FQ_EDGE, G1_GEN, G2_GEN, P, R, double_edge_triples,
    fq12_edge_pairs, fq_edge_triples, miller_step_edge_lanes, sqrt_edge_xs)
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from halo2_verifier_tpu_torch.ops.msm import combine_window_totals_grouped
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier

pytestmark = pytest.mark.cuda
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _limbs_t(vals, dev):
    return torch.from_numpy(
        ints_to_limbs(vals).T.astype(np.int32).copy()).to(dev)


def _field_values(modulus, n, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, (1 << 16) - 1, (1 << 255) % modulus, modulus - 1,
            (modulus + 1) // 2, 0xFFFF_FFFF_FFFF_FFFF]
    return edge + [int.from_bytes(rng.bytes(32), "little") % modulus
                   for _ in range(n - len(edge))]


@pytest.mark.parametrize("spec", [fm.FQ, fm.FR], ids=["fq", "fr"])
def test_mont_mul_kernel_matches_plain(cuda, spec):
    a = _limbs_t(_field_values(spec.modulus, 4096, 1), cuda)
    b = _limbs_t(_field_values(spec.modulus, 4096, 2)[::-1], cuda)
    before = kernels.LAUNCHES["mont_mul"]
    got = fm.mont_mul(a, b, spec)
    want = fm.mont_mul_body(a.long(), b.long(), spec).int()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["mont_mul"] == before + 1


def _points(n):
    step = hc.g1_mul(G1_GEN, 0x1234567)
    pts = [step]
    for _ in range(n - 1):
        pts.append(hc.g1_add(pts[-1], step))
    return pts


def _projective(points, dev):
    r = fm.FQ.mont_r
    xs = [0 if p is None else p[0] * r % P for p in points]
    ys = [0 if p is None else p[1] * r % P for p in points]
    return curve.from_affine(_limbs_t(xs, dev), _limbs_t(ys, dev))


def test_point_add_kernel_matches_plain(cuda):
    base = _points(256)
    pool = base + [hc.g1_neg(p) for p in base] + [None] * 8
    src = _projective(pool, cuda)
    n = len(pool)
    g = torch.Generator().manual_seed(0)
    iL = torch.randint(0, n, (4096,), generator=g, dtype=torch.int32)
    iR = torch.randint(0, n, (4096,), generator=g, dtype=torch.int32)
    iR[:256] = iL[:256]                                  # P + P
    iL[256:512] = torch.arange(256, dtype=torch.int32)
    iR[256:512] = torch.arange(256, 512, dtype=torch.int32)  # P + (-P)
    iL[512:520] = 512 + torch.arange(8, dtype=torch.int32)   # identity
    mask = torch.rand(4096, generator=g) < 0.8
    iL, iR, mask = iL.to(cuda), iR.to(cuda), mask.to(cuda)
    p = src
    for _ in range(2):
        got = curve.masked_add(p, p, mask, iL, iR)
        want = curve.masked_add_plain(p, p, mask, iL, iR)
        torch.cuda.synchronize()
        for o, w in zip(got, want):
            assert torch.equal(o, w)
        p = got
    aff = curve.to_affine_host(src)
    assert aff[:256] == base and aff[512:] == [None] * 8


def _to8(p):
    """A (16, B) int32 point or element on the card, re-limbed to
    (32, B) float32."""
    if isinstance(p, tuple):
        return tuple(_to8(c) for c in p)
    return torch.from_numpy(
        weights.limbs16_to_limbs8(p.cpu().numpy())).to(p.device)


def test_point_double_kernel_matches_plain(cuda):
    """K3 on random points, negatives and identities, then on its own
    output so Z is general; 2P equals the add kernel's P + P as a point.
    Then off-curve: the edge triples in the first lanes of seeded
    canonical triples at 1, 33 and 524,288 lanes, each output doubled
    again."""
    base = _points(1500)
    pool = base + [hc.g1_neg(p) for p in base[:500]] + [None] * 48
    p = _projective(pool, cuda)
    before = kernels.LAUNCHES["point_double"]
    for _ in range(2):
        got = curve.double(p)
        want = curve.double_plain(p)
        torch.cuda.synchronize()
        for o, w in zip(got, want):
            assert torch.equal(o, w)
        p = got
    assert kernels.LAUNCHES["point_double"] == before + 2
    src = _projective(pool, cuda)
    assert curve.to_affine_host(curve.double(src)) == curve.to_affine_host(
        curve.add(src, src)) == [hc.g1_double(q) for q in pool]
    edge = double_edge_triples()
    width = 524288
    rng = np.random.default_rng(11)
    coords = []
    for c in range(3):
        vals = ([t[c] for t in edge]
                + [int.from_bytes(rng.bytes(32), "little") % P
                   for _ in range(2048 - len(edge))])
        coords.append(_limbs_t(vals, cuda).repeat(1, width // 2048))
    for lanes in (1, 33, width):
        p = tuple(c[:, :lanes].contiguous() for c in coords)
        for _ in range(2):
            got = curve.double(p)
            want = curve.double_plain(p)
            torch.cuda.synchronize()
            for o, w in zip(got, want):
                assert torch.equal(o, w), lanes
            p = got


@pytest.mark.parametrize("spec", [fm.FQ, fm.FR], ids=["fq", "fr"])
def test_mont_mul8_kernel_matches_plain(cuda, spec):
    a16 = _limbs_t(_field_values(spec.modulus, 4096, 1), cuda)
    b16 = _limbs_t(_field_values(spec.modulus, 4096, 2)[::-1], cuda)
    a, b = f8.expand16_to8(a16), f8.expand16_to8(b16)
    before = kernels.LAUNCHES["mont_mul8"]
    got = f8.mont_mul(a, b, spec)
    want = f8.mont_mul_body(a, b, spec)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert kernels.LAUNCHES["mont_mul8"] == before + 1
    # the same product in the other format
    assert torch.equal(got, f8.expand16_to8(fm.mont_mul(a16, b16, spec)))


def test_point_add8_kernel_matches_plain(cuda):
    base = _points(256)
    pool = base + [hc.g1_neg(p) for p in base] + [None] * 8
    src16 = _projective(pool, cuda)
    src = _to8(src16)
    n = len(pool)
    g = torch.Generator().manual_seed(0)
    iL = torch.randint(0, n, (4096,), generator=g, dtype=torch.int32)
    iR = torch.randint(0, n, (4096,), generator=g, dtype=torch.int32)
    iR[:256] = iL[:256]                                  # P + P
    iL[256:512] = torch.arange(256, dtype=torch.int32)
    iR[256:512] = torch.arange(256, 512, dtype=torch.int32)  # P + (-P)
    iL[512:520] = 512 + torch.arange(8, dtype=torch.int32)   # identity
    mask = torch.rand(4096, generator=g) < 0.8
    iL, iR, mask = iL.to(cuda), iR.to(cuda), mask.to(cuda)
    before = kernels.LAUNCHES["point_add8"]
    p, p16 = src, src16
    for _ in range(2):
        got = curve.OPS8.masked_add(p, p, mask, iL, iR)
        want = curve.OPS8.masked_add_plain(p, p, mask, iL, iR)
        got16 = curve.masked_add(p16, p16, mask, iL, iR)
        torch.cuda.synchronize()
        for o, w, o16 in zip(got, want, got16):
            assert o.dtype == torch.float32 and torch.equal(o, w)
            assert torch.equal(o, f8.expand16_to8(o16))
        p, p16 = got, got16
    assert kernels.LAUNCHES["point_add8"] == before + 2


def test_point_add_kernels_on_edge_triples(cuda):
    """K2 and K5 on off-curve triples of the carry chains' edge values
    (every value in every coordinate, each triple once masked and once
    not), among random canonical lanes: bit for bit against the plain
    versions, and K5 against K2's re-limbed output."""
    triples = fq_edge_triples(range(15)) * 2
    rng = np.random.default_rng(8)
    width = 4096
    coords = []
    for c in range(6):
        vals = [t[c] for t in triples] + _field_values(
            P, width - len(triples), 10 + c)
        coords.append(_limbs_t(vals, cuda))
    p16, q16 = tuple(coords[:3]), tuple(coords[3:])
    mask = torch.from_numpy(rng.random(width) < 0.9)
    mask[:len(triples) // 2] = True
    mask[len(triples) // 2:len(triples)] = False
    mask = mask.to(cuda)
    p8, q8 = _to8(p16), _to8(q16)
    got16 = curve.masked_add(p16, q16, mask)
    got8 = curve.OPS8.masked_add(p8, q8, mask)
    want16 = curve.masked_add_plain(p16, q16, mask)
    want8 = curve.OPS8.masked_add_plain(p8, q8, mask)
    torch.cuda.synchronize()
    for o16, w16, o8, w8 in zip(got16, want16, got8, want8):
        assert torch.equal(o16, w16)
        assert torch.equal(o8, w8) and torch.equal(o8, f8.expand16_to8(o16))


def test_wrappers_refuse_tensors_past_32_bit_addressing(cuda, monkeypatch):
    """The kernels address rows in 32 bits; the wrappers refuse an operand
    or an output of kernels.MAX_ELEMENTS or more elements (the limit is
    lowered here so that small tensors reach it)."""
    p = _projective(_points(8), cuda)
    monkeypatch.setattr(kernels, "MAX_ELEMENTS", 16 * 8)
    with pytest.raises(ValueError):
        kernels.point_add(p, p)
    with pytest.raises(ValueError):
        kernels.mont_mul(p[0], p[1], 0)
    monkeypatch.setattr(kernels, "MAX_ELEMENTS", 16 * 8 + 1)
    idx = torch.zeros(9, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 9 output lanes from 8 input lanes
        kernels.point_add(p, p, iL=idx, iR=idx)
    kernels.point_add(p, p)  # at the limit less one: launches


def test_wrappers_refuse_cpu_tensors(cuda):
    """A kernel wrapper never gives way to the plain version: CPU tensors
    (or the other format's) raise."""
    p16 = _projective(_points(4), CPU)
    p8 = tuple(torch.from_numpy(weights.limbs16_to_limbs8(c.numpy()))
               for c in p16)
    with pytest.raises(ValueError):
        kernels.point_double(p16)
    with pytest.raises(ValueError):
        kernels.mont_mul8(p8[0], p8[1], 0)
    with pytest.raises(ValueError):
        kernels.point_add8(p8, p8)
    with pytest.raises(ValueError):
        kernels.point_add8(tuple(c.to(cuda) for c in p16),
                           tuple(c.to(cuda) for c in p16))
    with pytest.raises(ValueError):
        kernels.fq_addsub(p16[0], p16[1], kernels.FQ_ADD)
    with pytest.raises(ValueError):
        kernels.fq_inv(p16[0], 0)
    with pytest.raises(ValueError):
        kernels.fq_linmap(p16[0].reshape(16, 1, 4), tp._map_tensor(
            tp._FQ12_MA, cuda))
    x = torch.zeros((16, 12, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.fq12_mul(x, x)
    with pytest.raises(ValueError):  # not a (16, 12, B) stack
        kernels.fq12_mul(x[:, :6].contiguous().to(cuda),
                         x[:, :6].contiguous().to(cuda))
    T = torch.zeros((16, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.miller_step(kernels.MILLER_ADD, T, T, p16[0], p16[1])
    with pytest.raises(ValueError):  # P on another device than T
        kernels.miller_step(kernels.MILLER_DOUBLE, T.to(cuda), None,
                            p16[0], p16[1])


@pytest.mark.parametrize("backend", ["u16", "f8"])
def test_scan_on_card_equals_plain_and_host_msm(cuda, backend):
    pts = _points(600)
    rng = np.random.default_rng(4)
    sc = [int.from_bytes(rng.bytes(32), "little") % R for _ in pts]
    sc[0], sc[1], pts[2], pts[4] = 0, R - 1, None, pts[3]
    s_np = ints_to_limbs(sc)
    x_np = ints_to_limbs([0 if p is None else p[0] for p in pts])
    y_np = ints_to_limbs([0 if p is None else p[1] for p in pts])
    idx, keys, levels = msm_scan.host_plan(s_np, [200, 400])
    got = msm_scan.msm_window_totals_grouped(
        x_np, y_np, idx, keys, 2, levels, cuda, backend=backend)
    want = msm_scan.msm_window_totals_grouped(
        x_np, y_np, idx, keys, 2, levels, CPU, backend=backend)
    assert torch.equal(got.cpu(), want)
    assert combine_window_totals_grouped(got.cpu().numpy(), 2) == [
        hc.g1_msm(sc[:200], pts[:200]), hc.g1_msm(sc[200:], pts[200:])]
    assert msm_scan.msm_host(sc[:50], pts[:50], cuda) == hc.g1_msm(
        sc[:50], pts[:50])


@pytest.mark.parametrize("backend", ["u16", "f8"])
def test_k14_scan_stream_on_card(cuda, backend):
    """The scan path through the entry point: a valid and a tampered small
    batch of the main path's workload."""
    params, vk, items = weights.load_k14_mac_fixture()
    good = items[:16]
    bad = list(good)
    p, inst = bad[5]
    bad[5] = (p, [[(inst[0][0] + 1) % R] + inst[0][1:]])
    bv = BatchVerifier(params, vk, msm="scan", limb_backend=backend)
    kernels.reset_launches()
    res = list(bv.verify_stream([good, bad]))
    assert res[0].ok
    assert not res[1].ok and res[1].failed_indices == [5]
    add, mul = (("point_add8", "mont_mul8") if backend == "f8"
                else ("point_add", "mont_mul"))
    assert kernels.LAUNCHES[add] > 0 and kernels.LAUNCHES[mul] > 0


def test_sqrt_kernel_matches_k1_loop_and_plain(cuda):
    pts = _points(512)
    edge = sqrt_edge_xs()
    xs = _limbs_t([p[0] for p in pts] + edge
                  + _field_values(P, 512 - len(edge), 3), cuda)
    fused = decomp.y_principal(xs)
    loop = decomp.y_principal_k1(xs)
    plain = decomp.y_principal_plain(xs)
    torch.cuda.synchronize()
    assert torch.equal(fused, plain) and torch.equal(loop, plain)
    roots = limbs_to_ints(fused.cpu().numpy().T)
    assert all(p[1] in (r, P - r) for p, r in zip(pts, roots[:512]))
    assert roots[512:512 + len(edge)] == [
        pow((x ** 3 + 3) % P, (P + 1) // 4, P) for x in edge]


def test_frontier0_kernel_matches_plain(cuda):
    """The level-0 frontier kernel on random points, (0, 0) lanes (the
    identity pad's among them) and repeated indices, against
    frontier0_plain; one launch, no Montgomery-multiply launch."""
    pts = _points(1000) + [None] * 23 + [None]  # the last lane: the pad
    xs = _limbs_t([0 if p is None else p[0] for p in pts], cuda)
    ys = _limbs_t([0 if p is None else p[1] for p in pts], cuda)
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, len(pts), (8192,), generator=g, dtype=torch.int32)
    idx[:64] = 7                       # one point many times
    idx[64:128] = len(pts) - 1         # the identity pad
    idx[128:160] = 1000 + torch.arange(32, dtype=torch.int32) % 23
    idx = idx.to(cuda)
    kernels.reset_launches()
    got = msm_forest.frontier0(xs, ys, idx)
    want = msm_forest.frontier0_plain(xs, ys, idx)
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in zip(got, want))
    assert kernels.LAUNCHES["forest_frontier0"] == 1
    assert kernels.LAUNCHES["mont_mul"] == 0
    aff = curve.to_affine_host(tuple(c[:, :256] for c in got))
    assert aff == [pts[i] for i in idx[:256].tolist()]


def test_forest_on_card_equals_plain_and_host_msm(cuda):
    pts = _points(600)
    rng = np.random.default_rng(4)
    sc = [int.from_bytes(rng.bytes(32), "little") % R for _ in pts]
    s_np = ints_to_limbs(sc)
    x_np = ints_to_limbs([p[0] for p in pts])
    y_np = ints_to_limbs([p[1] for p in pts])
    plan = msm_forest.host_plan(s_np, [200, 400])
    kernels.reset_launches()
    got = msm_forest.dispatch_planned(x_np, y_np, plan, cuda)
    want = msm_forest.dispatch_planned(x_np, y_np, plan, CPU)
    assert torch.equal(got.cpu(), want)
    # one frontier launch and the point adds; no Montgomery multiply
    assert kernels.LAUNCHES["forest_frontier0"] == 1
    assert kernels.LAUNCHES["mont_mul"] == 0
    assert combine_window_totals_grouped(got.cpu().numpy(), 2) == [
        hc.g1_msm(sc[:200], pts[:200]), hc.g1_msm(sc[200:], pts[200:])]


def test_k14_stream_on_card(cuda):
    """Two small streamed batches of the main path's workload on the card,
    the second with one public input changed by +1."""
    params, vk, items = weights.load_k14_mac_fixture()
    good = items[:16]
    bad = list(good)
    p, inst = bad[5]
    bad[5] = (p, [[(inst[0][0] + 1) % R] + inst[0][1:]])
    bv = BatchVerifier(params, vk)
    kernels.reset_launches()
    res = list(bv.verify_stream([good, bad]))
    assert res[0].ok
    assert not res[1].ok and res[1].failed_indices == [5]
    assert all(kernels.LAUNCHES[k] > 0
               for k in ("forest_frontier0", "sqrt_principal", "point_add"))
    assert kernels.LAUNCHES["mont_mul"] == 0


def _fq_operands(n, seed):
    """(a, b) of n canonical Fq values each: the edge values (0, p - 1,
    the FOLD_EDGE pairs, ...) against each other, then random."""
    a = FQ_EDGE + [x for x, _ in FOLD_EDGE]
    b = FQ_EDGE[::-1] + [y for _, y in FOLD_EDGE]
    rng = np.random.default_rng(seed)
    a += [int.from_bytes(rng.bytes(32), "little") % P
          for _ in range(n - len(a))]
    b += [int.from_bytes(rng.bytes(32), "little") % P
          for _ in range(n - len(b))]
    return a, b


def test_fq_addsub_kernel_matches_plain(cuda):
    """T1: add, sub and neg on the edge values and random ones, one
    operand a column slice of a wider tensor (its own row stride)."""
    a, b = _fq_operands(1000, 21)
    A = _limbs_t(a + b, cuda)[:, :1000]  # row stride 2,000
    B = _limbs_t(b, cuda)
    before = kernels.LAUNCHES["fq_addsub"]
    for op, plain in ((kernels.FQ_ADD, fm.add_body),
                      (kernels.FQ_SUB, fm.sub_body)):
        got = kernels.fq_addsub(A, B, op)
        assert torch.equal(got, plain(A.long(), B.long(), fm.FQ).int())
    got = kernels.fq_addsub(A, None, kernels.FQ_NEG)
    assert torch.equal(got, fm.neg_body(A.long(), fm.FQ).int())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fq_addsub"] == before + 3
    assert limbs_to_ints(got.cpu().numpy().T) == [(-x) % P for x in a]


@pytest.mark.parametrize("name", ["_FQ12_MA", "_FQ12_MB", "_FQ12_MC"])
def test_fq_linmap_kernel_matches_plain(cuda, name):
    """T2 on the three Fq12 maps at 1 and 300 lanes, edge values included."""
    M = getattr(tp, name)
    k = M.shape[1]
    vals, _ = _fq_operands(k * 300, 22)
    X = _limbs_t(vals, cuda).reshape(16, k, 300)
    for x in (X[:, :, :1].contiguous(), X):
        got = kernels.fq_linmap(x, tp._map_tensor(M, cuda))
        assert torch.equal(got, tp.linear_combine_plain(x, M))


def _fq12_stacks(width, seed, dev):
    """Two (16, 12, width) int32 coefficient stacks: the edge pairs of
    constants.fq12_edge_pairs in the first lanes, seeded random canonical
    values after."""
    pairs = fq12_edge_pairs()
    rng = np.random.default_rng(seed)
    stacks = []
    for side in (0, 1):
        vals = [[p[side][c] for p in pairs[:width]] for c in range(12)]
        for c in range(12):
            vals[c] += [int.from_bytes(rng.bytes(32), "little") % P
                        for _ in range(width - len(vals[c]))]
        stacks.append(torch.stack([_limbs_t(v, dev) for v in vals], dim=1))
    return stacks


@pytest.mark.parametrize("width", [1, 2, 16384])
def test_fq12_mul_kernel_matches_plain(cuda, width):
    """The fused Fq12 multiply, and its square (one operand), at the
    pairing's widths and at 16,384 lanes, edge pairs included, against
    the plain composition; one launch each."""
    a, b = _fq12_stacks(width, 24 + width, cuda)
    before = kernels.LAUNCHES["fq12_mul"]
    got = tp.fq12_mul_stack(a, b)
    square = tp.fq12_mul_stack(a, a)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fq12_mul"] == before + 2
    assert torch.equal(got, tp.fq12_mul_plain(a, b))
    assert torch.equal(square, tp.fq12_mul_plain(a, a))


@pytest.mark.parametrize("spec", [fm.FQ, fm.FR], ids=["fq", "fr"])
def test_fq_inv_kernel_matches_plain(cuda, spec):
    """T3 through field.inv_mont (0, 1, N - 1, N - 2 and the FOLD_EDGE
    values among the operands) against the plain body; inv(0) = 0."""
    vals = [v % spec.modulus for v in _fq_operands(256, 23)[0]]
    vals[1:4] = [1, spec.modulus - 1, spec.modulus - 2]
    a = _limbs_t(vals, cuda)
    before = kernels.LAUNCHES["fq_inv"]
    got = fm.inv_mont(a, spec)
    want = fm.inv_mont_body(a.long(), spec).int()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["fq_inv"] == before + 1
    assert int(got[:, vals.index(0)].abs().sum()) == 0


@pytest.mark.parametrize("spec", [fm.FQ, fm.FR], ids=["fq", "fr"])
def test_field_minor_kernels_match_plain(cuda, spec):
    """The limb-minor field layer on the card: mont_mul (one K1 launch on
    (3, 5, 16) operands against a (16,) constant), inv_mont (one T3) and
    pow_fixed (K1 per product) against their plain versions."""
    vals = _field_values(spec.modulus, 15, 31)
    a = _limbs_t(vals, cuda).t().contiguous().reshape(3, 5, 16)
    c = _limbs_t(_field_values(spec.modulus, 9, 32)[-1:], cuda)[:, 0]
    before = dict(kernels.LAUNCHES)
    got = fmin.mont_mul(a, c, spec)
    assert kernels.LAUNCHES["mont_mul"] == before["mont_mul"] + 1
    assert torch.equal(got, fmin.mont_mul(a, c, spec, plain=True))
    got = fmin.inv_mont(a, spec)
    assert kernels.LAUNCHES["fq_inv"] == before["fq_inv"] + 1
    assert torch.equal(got, fmin.inv_mont(a, spec, plain=True))
    e = 0xDEADBEEF12345
    got = fmin.pow_fixed(a, e, spec)
    assert kernels.LAUNCHES["mont_mul"] == (before["mont_mul"] + 1 + bin(
        e).count("1") + e.bit_length() - 1)
    assert torch.equal(got, fmin.pow_fixed(a, e, spec, plain=True))


def test_curve_minor_kernels_match_plain(cuda):
    """The limb-minor curve layer on the card: add (one K2), double (one
    K3) and to_affine_batch (T3 and two K1) on (2, 64) batches of points,
    identities and P + (-P) among them, against their plain versions."""
    base = _points(128)
    pts = base[:64] + [None] * 8 + base[72:]
    qs = [hc.g1_neg(p) if i % 5 == 0 else base[(i * 7) % 128]
          for i, p in enumerate(pts)]
    p = tuple(c.t().contiguous().reshape(2, 64, 16)
              for c in _projective(pts, cuda))
    q = tuple(c.t().contiguous().reshape(2, 64, 16)
              for c in _projective(qs, cuda))
    before = dict(kernels.LAUNCHES)
    r = cmin.add(p, q)
    assert kernels.LAUNCHES["point_add"] == before["point_add"] + 1
    assert all(torch.equal(g, w) for g, w in zip(
        r, cmin.add(p, q, plain=True)))
    d = cmin.double(r)
    assert kernels.LAUNCHES["point_double"] == before["point_double"] + 1
    assert all(torch.equal(g, w) for g, w in zip(
        d, cmin.double(r, plain=True)))
    xy = cmin.to_affine_batch(d)
    assert kernels.LAUNCHES["fq_inv"] == before["fq_inv"] + 1
    assert kernels.LAUNCHES["mont_mul"] == before["mont_mul"] + 2
    assert all(torch.equal(g, w) for g, w in zip(
        xy, cmin.to_affine_batch(d, plain=True)))


def _step_operands(width, seed, dev):
    """(T, Q, (px, py)) Miller step operands of `width` lanes: the edge
    lanes of constants.miller_step_edge_lanes first, seeded random
    canonical values after; px and py rows of one (2, 16, width) tensor,
    as pairing_product holds them."""
    lanes = miller_step_edge_lanes()[:width]
    rng = np.random.default_rng(seed)
    lanes += [tuple(int.from_bytes(rng.bytes(32), "little") % P
                    for _ in range(10)) for _ in range(width - len(lanes))]
    cols = [_limbs_t([lane[c] for lane in lanes], dev) for c in range(10)]
    P_ = torch.stack(cols[8:])
    return (torch.stack(cols[:4], dim=1), torch.stack(cols[4:8], dim=1),
            (P_[0], P_[1]))


@pytest.mark.parametrize("width", [1, 2, 33, 16384])
def test_miller_step_kernel_matches_plain(cuda, width):
    """The Miller step in both modes, at the pairing's widths, past one
    warp and at 16,384 lanes, edge lanes included (a zero denominator in
    each mode), against the plain version; one launch each."""
    T, Q, P_ = _step_operands(width, 25 + width, cuda)
    for mode, q in ((kernels.MILLER_DOUBLE, None), (kernels.MILLER_ADD, Q)):
        before = kernels.LAUNCHES["miller_step"]
        got_t, got_line = tp._miller_step(mode, T, q, P_)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["miller_step"] == before + 1
        want_t, want_line = tp.miller_step_plain(mode, T, q, P_)
        assert torch.equal(got_t, want_t)
        assert torch.equal(got_line, want_line)


# kernel launches of one device pairing check of two live pairs
PAIRING_LAUNCHES = {"mont_mul": 13, "fq_addsub": 501, "fq12_mul": 1318,
                    "fq_inv": 1, "miller_step": 102}


def test_device_pairing_on_card(cuda):
    """The device pairing on the card: Miller lanes equal the oracle's,
    the bilinearity verdicts the oracle's; a check launches K1, T1, the
    fused Fq12 multiply, T3 and the Miller step as many times as the
    dispatch counts on the CPU (tests/test_torch_fq12_fused.py), and no
    T2."""
    pairs = [(hc.g1_mul(G1_GEN, 3), hc.g2_mul(G2_GEN, 5)),
             (hc.g1_mul(G1_GEN, 7), hc.g2_mul(G2_GEN, 11))]
    g1 = np.stack([tp.mont_cols([p[0] for p, _ in pairs]),
                   tp.mont_cols([p[1] for p, _ in pairs])])
    g2 = np.stack([tp.mont_cols([q[i][j] for _, q in pairs])
                   for i in range(2) for j in range(2)])
    kernels.reset_launches()
    lanes = tp.miller_lanes(torch.from_numpy(g1).to(cuda),
                            torch.from_numpy(g2).to(cuda))
    for i, (p, q) in enumerate(pairs):
        assert tp.fq12_from_device(lanes, lane=i) == hp.miller_loop(p, q)
    good = [(hc.g1_mul(G1_GEN, 6), hc.g2_mul(G2_GEN, 13)),
            (hc.g1_neg(hc.g1_mul(G1_GEN, 78)), G2_GEN)]
    bad = [good[0], (hc.g1_neg(hc.g1_mul(G1_GEN, 79)), G2_GEN)]
    assert tp.pairing_check_device(good) is True
    kernels.reset_launches()
    assert tp.pairing_check_device(bad, cuda) is False
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == \
        PAIRING_LAUNCHES
