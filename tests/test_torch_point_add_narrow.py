"""The 16-bit point add's narrow shape (csrc/point.cuh NarrowShape,
narrow::point_add_kernel): the launcher's rule and its counter on the CPU,
and on the card the narrow shape bit-equal to the plain version and to
the wide kernel at the rule's edges, with indices, masks, scatter lanes
and the carry chains' edge values, and the packed chain at the k=14 and
k=9 signatures bit-equal to the same chain on the plain versions.

This file imports neither jax nor the JAX package; on a machine with a
card and without them:

    python -m pytest --noconftest -q tests/test_torch_point_add_narrow.py
"""

import numpy as np
import pytest
import torch

from halo2_verifier_tpu_torch.ops import curve, kernels, msm_forest
from halo2_verifier_tpu_torch.ops import field as fm
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops.constants import (G1_GEN, P, R,
                                                    fq_edge_triples)
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs

STUB_BELOW = 100


@pytest.fixture
def stub_below(monkeypatch):
    """The library's threshold replaced by STUB_BELOW, counters zeroed."""
    monkeypatch.setattr(kernels, "narrow_below", lambda: STUB_BELOW)
    kernels.reset_launches()
    yield STUB_BELOW
    kernels.reset_launches()


@pytest.mark.parametrize("lanes", [0, 64, STUB_BELOW - 1, STUB_BELOW,
                                   STUB_BELOW + 1, 4096])
def test_narrow_counter_follows_the_library_threshold(stub_below, lanes):
    """A K2 launch counts in point_add always and in point_add_narrow
    exactly when its add lanes are below the library's threshold."""
    kernels._count_point_add(lanes, ("args",))
    narrow = lanes < stub_below
    assert (kernels.LAUNCHES["point_add"], kernels.LANES["point_add"]) == (
        1, lanes)
    assert (kernels.LAUNCHES["point_add_narrow"],
            kernels.LANES["point_add_narrow"]) == (int(narrow),
                                                   lanes if narrow else 0)


def test_narrow_launches_are_counted_per_replay(stub_below):
    """Under a capture the narrow launches go to the tally beside the
    point add's; each replay of it counts them once more."""
    with kernels.recorded_launches() as tally:
        for lanes in (4096, 512, 64, 64, STUB_BELOW, 0):
            kernels._count_point_add(lanes, ())
    assert tally == {"point_add": (6, 4096 + 512 + 128 + STUB_BELOW),
                     "point_add_narrow": (3, 128)}
    assert kernels.LAUNCHES["point_add_narrow"] == 0
    for _ in range(3):
        kernels.count_replay(tally)
    assert (kernels.LAUNCHES["point_add"],
            kernels.LAUNCHES["point_add_narrow"],
            kernels.LANES["point_add_narrow"]) == (18, 9, 384)


def test_kernel_label_keeps_the_narrow_namespace():
    """The two shapes of the 16-bit add keep apart in the build report."""
    tail = ("INS_6Limbs16EEEvPKNT_1TES5_S5_jS5_S5_S5_jPKiS7_PKhPS3_SB_SB_j"
            "NS_11PartScatterIS2_EE")
    assert kernels.kernel_label(
        "_ZN3h2v6narrow16point_add_kernel" + tail) == (
            "narrow::point_add_kernel<Limbs16>")
    assert kernels.kernel_label("_ZN3h2v16point_add_kernel" + tail) == (
        "point_add_kernel<Limbs16>")


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _limbs_t(vals, dev):
    return torch.from_numpy(
        ints_to_limbs(vals).T.astype(np.int32).copy()).to(dev)


def _points(n):
    step = hc.g1_mul(G1_GEN, 0x1234567)
    pts = [step]
    for _ in range(n - 1):
        pts.append(hc.g1_add(pts[-1], step))
    return pts


def _frontier(dev):
    """256 points, their negatives and 8 identities, projective."""
    base = _points(256)
    pool = base + [hc.g1_neg(p) for p in base] + [None] * 8
    r = fm.FQ.mont_r
    xs = [0 if p is None else p[0] * r % P for p in pool]
    ys = [0 if p is None else p[1] * r % P for p in pool]
    return curve.from_affine(_limbs_t(xs, dev), _limbs_t(ys, dev))


def _indices(n, width, seed, special=True):
    """Random iL, iR and mask over `width` lanes of an n-lane frontier;
    with `special`, of _frontier's layout, P + P, P + (-P) and identity
    lanes first."""
    g = torch.Generator().manual_seed(seed)
    iL = torch.randint(0, n, (width,), generator=g, dtype=torch.int32)
    iR = torch.randint(0, n, (width,), generator=g, dtype=torch.int32)
    k = width // 8
    if special:
        iR[:k] = iL[:k]                                    # P + P
        j = torch.arange(k, 2 * k, dtype=torch.int32) % 256
        iL[k:2 * k], iR[k:2 * k] = j, j + 256              # P + (-P)
        iL[2 * k:3 * k] = 512 + torch.arange(k, dtype=torch.int32) % 8
    mask = torch.rand(width, generator=g) < 0.8
    return iL, iR, mask


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _widths():
    """64, 512 and the threshold's neighbours, read from the library at
    run time (a parametrize argument is fixed at collection)."""
    t = kernels.narrow_below()
    return (64, 512, t - 1, t, t + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("which", range(5))
def test_narrow_shape_matches_plain_and_wide(cuda, which):
    """One launch at 64, 512, threshold - 1, threshold and threshold + 1
    add lanes, gathered by index and masked, twice (the second round adds
    general projective points): bit-equal to the plain version, and on
    the lanes it shares with a launch of the other shape (the narrow
    one's lanes padded past the threshold, or the wide one's first
    threshold - 1) bit-equal to it; counted as narrow below the
    threshold only."""
    below = kernels.narrow_below()
    width = _widths()[which]
    src = _frontier(cuda)
    p = src
    for rnd in range(2):
        iL, iR, mask = (t.to(cuda) for t in _indices(
            p[0].shape[1], width, 10 * which + rnd, special=rnd == 0))
        kernels.reset_launches()
        got = curve.masked_add(p, p, mask, iL, iR)
        narrow = (kernels.LAUNCHES["point_add_narrow"],
                  kernels.LANES["point_add_narrow"])
        assert narrow == ((1, width) if width < below else (0, 0))
        want = curve.masked_add_plain(p, p, mask, iL, iR)
        if width < below:      # the same lanes in a wide launch
            n = below + 1
            pad = torch.arange(n - width, dtype=torch.int32,
                               device=cuda) % p[0].shape[1]
            other = curve.masked_add(
                p, p, torch.cat([mask, mask.new_ones(n - width)]),
                torch.cat([iL, pad]), torch.cat([iR, pad]))
            other = tuple(c[:, :width] for c in other)
            shared = got
        else:                  # the first lanes in a narrow launch
            n = below - 1
            other = curve.masked_add(p, p, mask[:n].contiguous(),
                                     iL[:n].contiguous(),
                                     iR[:n].contiguous())
            shared = tuple(c[:, :n] for c in got)
        torch.cuda.synchronize()
        assert _equal(got, want)
        assert _equal(shared, other)
        p = tuple(c.contiguous() for c in got)
    assert curve.to_affine_host(src)[512:] == [None] * 8


@pytest.mark.cuda
@pytest.mark.parametrize("which", range(4))
def test_narrow_scatter_lanes_match_plain(cuda, which):
    """h2v_point_add_scatter at 64, threshold - 1, threshold and 0 add
    lanes with 700 scatter lanes: the add lanes equal masked_add_plain's
    and the grid equals scatter_part_plain's, (0, 0, 0) entries patched
    to (0 : R : 0) and identities kept (the dump slot, written by several
    lanes, left out)."""
    below = kernels.narrow_below()
    width = (64, below - 1, below, 0)[which]
    src = tuple(c.clone() for c in _frontier(cuda))
    for c in src:
        c[:, 100:104] = 0                                  # (0, 0, 0)
    n = src[0].shape[1]
    g = torch.Generator().manual_seed(20 + which)
    tw = 4
    dump = tw * msm_forest.NUM_BUCKETS
    pos = torch.randint(0, n, (700,), generator=g, dtype=torch.int32)
    pos[:8] = 512 + torch.arange(8, dtype=torch.int32)    # identities
    pos[8:12] = 100 + torch.arange(4, dtype=torch.int32)
    keys = torch.randperm(dump, generator=g)[:700].to(torch.int32)
    keys[650:] = dump                                      # identity padding
    iL, iR = (None, None) if width == 0 else (
        t.to(cuda) for t in _indices(n, width, 30 + which)[:2])
    pos, keys = pos.to(cuda), keys.to(cuda)
    grid0 = msm_forest._identity_grid(tw)
    grid = grid0.clone().to(cuda)
    want_grid = grid0.clone()
    kernels.reset_launches()
    got = kernels.point_add_scatter(src, iL, iR, pos, keys,
                                    (grid[0], grid[1], grid[2]))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["point_add_narrow"] == int(width < below)
    if width:
        assert _equal(got, curve.masked_add_plain(src, src, iL=iL, iR=iR))
    else:
        assert got[0].shape == (16, 0)
    msm_forest.scatter_part_plain(tuple(c.cpu() for c in src), pos.cpu(),
                                  keys.cpu(), (want_grid[0], want_grid[1],
                                               want_grid[2]))
    assert torch.equal(grid.cpu()[:, :, :dump], want_grid[:, :, :dump])
    patched = grid.cpu()[:, :, keys[8:12].cpu().long()]
    assert torch.equal(patched, grid0[:, :, :4])          # (0 : R : 0)


@pytest.mark.cuda
def test_narrow_shape_on_edge_triples(cuda):
    """Off-curve triples of the carry chains' edge values (the FOLD_EDGE
    pairs in each product, every FQ_EDGE value in every coordinate), each
    once masked and once not, in a 512-lane narrow launch: bit-equal to
    the plain version and to the same lanes of a wide launch."""
    triples = fq_edge_triples(range(15)) * 2
    width = 512
    below = kernels.narrow_below()
    assert len(triples) <= width < below
    rng = np.random.default_rng(11)
    coords = []
    for c in range(6):
        vals = [t[c] for t in triples] + [
            int.from_bytes(rng.bytes(32), "little") % P
            for _ in range(below + 1 - len(triples))]
        coords.append(_limbs_t(vals, cuda))
    mask = torch.from_numpy(rng.random(below + 1) < 0.9)
    mask[:len(triples) // 2] = True
    mask[len(triples) // 2:len(triples)] = False
    mask = mask.to(cuda)
    p_wide, q_wide = tuple(coords[:3]), tuple(coords[3:])
    p, q = (tuple(c[:, :width].contiguous() for c in s)
            for s in (p_wide, q_wide))
    kernels.reset_launches()
    got = curve.masked_add(p, q, mask[:width].contiguous())
    assert kernels.LAUNCHES["point_add_narrow"] == 1
    wide = curve.masked_add(p_wide, q_wide, mask)
    assert kernels.LAUNCHES["point_add_narrow"] == 1
    want = curve.masked_add_plain(p, q, mask[:width])
    torch.cuda.synchronize()
    assert _equal(got, want)
    assert _equal(got, tuple(c[:, :width] for c in wide))


# the MSM groups of one batch of each benchmark cell: k=14 SHPLONK, 1,024
# proofs; k=9 GWC, 256 proofs (the stream's padded left and right sides)
SIGNATURES = {"k14": (1024, 15616), "k9": (768, 5376)}


@pytest.mark.cuda
@pytest.mark.parametrize("sig", sorted(SIGNATURES))
def test_packed_chain_equals_plain_chain_at_cell_signature(
        cuda, sig, monkeypatch):
    """The packed chain of a batch of each cell's signature (random
    scalars, real points and identities) on the card: its window totals
    are bit-equal to the same chain with every point add on its plain
    version (on the card), so its narrow launches change no bit; and it
    takes the narrow shape in every launch below the threshold, the
    bucket phase's 21 included."""
    sizes = SIGNATURES[sig]
    n = sum(sizes)
    pts = _points(2048)
    rng = np.random.default_rng(40 + len(sig))
    pick = rng.integers(0, len(pts), n)
    pp = [None if i % 97 == 5 else pts[k] for i, k in enumerate(pick)]
    sc = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    x_np = ints_to_limbs([0 if p is None else p[0] for p in pp])
    y_np = ints_to_limbs([0 if p is None else p[1] for p in pp])
    plan = msm_forest.host_plan(ints_to_limbs(sc), list(sizes))
    layout = msm_forest.packed_layout(plan)
    buf = np.empty(layout.total, dtype=np.int32)
    msm_forest.pack_operands(x_np, y_np, plan, layout, buf)
    dev_buf = torch.from_numpy(buf).to(cuda)
    below = kernels.narrow_below()
    kernels.reset_launches()
    got = msm_forest.packed_chain(dev_buf, layout)
    torch.cuda.synchronize()
    widths = [w for _oL, _oR, w in layout.levels] + [0]
    tw = layout.tw
    folds = [tw * msm_forest.WINDOW_BITS << k for k in range(7)]
    narrow = sum(w < below for w in widths + folds) + 14
    assert kernels.LAUNCHES["point_add"] == len(widths) + 7 + 14
    assert kernels.LAUNCHES["point_add_narrow"] == narrow >= 21

    def scatter_plain(f, iL, iR, pos, keys, grid):
        msm_forest.scatter_part_plain(f, pos, keys, grid)
        return (curve.masked_add_plain(f, f, iL=iL, iR=iR)
                if iL is not None else None)

    monkeypatch.setattr(kernels, "point_add_scatter", scatter_plain)
    monkeypatch.setattr(curve.OPS16, "kernel", curve.OPS16.masked_add_plain)
    want = msm_forest.packed_chain(dev_buf, layout)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
