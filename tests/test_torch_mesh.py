"""PyTorch port, the sharded forest MSMs (halo2_verifier_tpu_torch/
parallel/mesh.py) against the JAX package's mesh, mirroring
tests/test_parallel.py: on its inputs (40 points in groups of 17 and 23,
duplicates and identities, scalars from a numpy seed) eight gloo CPU
ranks run the window-sharded forest (both uploads) and the point-sharded
forest, and each rank's (3, 16, tw/8) projective window totals are
bit-equal to the JAX mesh's for that device on make_mesh(8); the combined
points equal the JAX combine and the exact host MSM. In-process: the
orchestrator's dispatch fall-through by mesh size (windows -> forest ->
scan, the scan's identity padding), a world of one bit-equal to the
single-device forest, both forest kinds on the single-device chain's
forest_grid and plane_reduce, and the checks that refuse an indivisible
mesh."""

import jax
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu_torch.ops import msm_forest, msm_scan
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, G2_GEN, R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs
from halo2_verifier_tpu_torch.parallel import mesh as pmesh
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier

from torch_ranks import start_ranks, wait_ranks

CPU = torch.device("cpu")
SIZES = [17, 23]

WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from halo2_verifier_tpu_torch.parallel import dist
from halo2_verifier_tpu_torch.parallel import mesh as pmesh

out = sys.argv[1]
assert dist.init_distributed(device="cpu", timeout=120)
mesh = pmesh.make_mesh(8, device="cpu")
z = np.load(os.path.join(out, "case.npz"))
s, x, y, sizes = z["s"], z["x"], z["y"], [int(v) for v in z["sizes"]]
res = {}
for kind in ("windows_shard", "windows_replicate", "forest"):
    stats = {}
    if kind == "forest":
        res[kind] = pmesh.sharded_forest_window_totals(
            mesh, x, y, s, sizes, stats=stats).numpy()
    else:
        res[kind] = pmesh.sharded_forest_by_windows(
            mesh, x, y, s, sizes, stats=stats,
            upload=kind.split("_")[1]).numpy()
    res["stats_" + kind] = np.asarray(
        [stats[k] for k in ("upload_bytes", "upload_bytes_per_chip",
                            "collective_bytes_per_chip",
                            "fetch_bytes_per_chip")])
if mesh.rank == 0:
    from halo2_verifier_tpu_torch.ops import msm_forest
    res["single"] = msm_forest.dispatch_planned(
        x, y, msm_forest.host_plan(s, sizes), torch.device("cpu")).numpy()
np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **res)
dist.shutdown()
print(f"MESH_OK rank={mesh.rank}", flush=True)
"""
KINDS = ["windows_shard", "windows_replicate", "forest"]
# the columns of a rank's stats_<kind> row
UPLOAD, UPLOAD_PER_CHIP, COLLECTIVE, FETCH = range(4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed=5):
    """tests/test_parallel.py's sharded-forest inputs, from a numpy seed:
    (scalar, x, y limbs, host points, scalars)."""
    rng = np.random.RandomState(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R
               for _ in range(sum(SIZES))]
    pool = [jhc.g1_mul(G1_GEN, 3 + i) for i in range(7)]
    points = [None if i % 11 == 10 else pool[i % 7]
              for i in range(sum(SIZES))]
    s = ints_to_limbs(scalars)
    x = ints_to_limbs([0 if p is None else p[0] for p in points])
    y = ints_to_limbs([0 if p is None else p[1] for p in points])
    return s, x, y, points, scalars


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """The eight ranks' totals beside the JAX mesh's on the same inputs:
    the ranks (and rank 0's single-device forest) run while the JAX
    package compiles and runs its mesh, which takes most of the time."""
    from halo2_verifier_tpu.parallel import mesh as jmesh

    if len(jax.devices()) < 8:
        pytest.skip("the JAX side needs 8 virtual devices")
    work = tmp_path_factory.mktemp("mesh8")
    s, x, y, points, scalars = _case()
    np.savez(work / "case.npz", s=s, x=x, y=y, sizes=np.asarray(SIZES))
    procs = start_ranks(WORKER, 8, work)
    try:
        jm = jmesh.make_mesh(8)
        jstats = {}
        jax_res = {
            "windows": np.asarray(jmesh.sharded_forest_by_windows(
                jm, x, y, s, SIZES, stats=jstats)),
            "forest": np.asarray(jmesh.sharded_forest_window_totals(
                jm, x, y, s, SIZES)),
        }
        jax_points = {
            "windows": jmesh.combine_sharded_windows(jax_res["windows"], 2),
            "forest": jmesh.combine_sharded_forest(jax_res["forest"], 2),
        }
    finally:
        outs = wait_ranks(procs, work, timeout=400)
    for r, out in enumerate(outs):
        assert f"MESH_OK rank={r}" in out, out
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(8)]
    want = [jhc.g1_msm(scalars[:17], points[:17]),
            jhc.g1_msm(scalars[17:], points[17:])]
    return ranks, jax_res, jax_points, jstats, want, ranks[0]["single"]


@pytest.mark.parametrize("kind", KINDS)
def test_per_rank_totals_bit_equal_jax_mesh(eight_ranks, kind):
    """Rank d's projective window totals are the JAX mesh's device d
    totals, bit for bit; every rank holds all eight (the all_gather)."""
    ranks, jax_res, _jp, _js, _want, _single = eight_ranks
    want = jax_res[kind.split("_")[0]].view(np.int32)
    for r, res in enumerate(ranks):
        got = res[kind]
        assert got.shape == want.shape == (8, 3, 16, 8)
        np.testing.assert_array_equal(got[r], want[r])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["windows", "forest"])
def test_combined_points_equal_jax_and_host_msm(eight_ranks, kind):
    ranks, _jr, jax_points, _js, want, _single = eight_ranks
    combine = {"windows": pmesh.combine_sharded_windows,
               "forest": pmesh.combine_sharded_forest}[kind]
    got = combine(ranks[0]["windows_shard" if kind == "windows"
                           else "forest"], 2)
    assert got == jax_points[kind] == want


@pytest.mark.parametrize("upload", pmesh.UPLOADS)
def test_window_sharded_totals_equal_single_device(eight_ranks, upload):
    """A bucket's forest depends on its own entries alone, so the window
    kind's totals, put back in window order, are the single-device
    forest's bit for bit."""
    ranks, _jr, _jp, _js, _want, single = eight_ranks
    for res in ranks:
        np.testing.assert_array_equal(
            pmesh.windows_in_order(res["windows_" + upload], 2), single)


def test_wire_stats_match_reference(eight_ranks):
    """The wire accounting the reference keeps: the sharded upload's
    all_gather bytes and the totals' bytes per rank equal the JAX
    mesh's; the replicated upload gathers nothing and uploads more; the
    forest kind's all_to_all moves each rank's whole (3, 16, 64 * 256)
    grid."""
    ranks, _jr, _jp, jstats, _want, _single = eight_ranks
    for res in ranks:
        shard, rep = res["stats_windows_shard"], res["stats_windows_replicate"]
        assert (shard[COLLECTIVE], shard[FETCH]) == (
            jstats["collective_bytes_per_chip"],
            jstats["fetch_bytes_per_chip"])
        assert rep[COLLECTIVE] == 0
        assert rep[UPLOAD_PER_CHIP] > shard[UPLOAD_PER_CHIP]
        forest = res["stats_forest"]
        assert (forest[COLLECTIVE], forest[FETCH]) == (3 * 16 * 64 * 256 * 4,
                                                       3 * 16 * 8 * 4)


@pytest.mark.parametrize("kind", KINDS)
def test_upload_bytes_sum_over_ranks(eight_ranks, kind):
    """Each rank plans its own windows or points, so the upload in all is
    the sum of the ranks' own uploads, which every rank reports alike."""
    ranks, _jr, _jp, _js, _want, _single = eight_ranks
    rows = [res["stats_" + kind] for res in ranks]
    assert {int(r[UPLOAD]) for r in rows} == {
        sum(int(r[UPLOAD_PER_CHIP]) for r in rows)}


# ------------------------------------------------------------ in-process

def _fake_mesh(size):
    return pmesh.Mesh(size, 0, CPU)


@pytest.mark.parametrize("size,msm,shard,kind", [
    (1, "forest", None, "sharded_windows"),
    (4, "forest", None, "sharded_windows"),
    (8, "forest", "windows", "sharded_windows"),
    (8, "forest", "forest", "sharded_forest"),
    (64, "forest", None, "sharded_forest"),
    (64, "forest", "windows", "sharded_grouped"),
    (3, "forest", None, "sharded_grouped"),
    (4, "forest", "scan", "sharded_grouped"),
    (4, "scan", None, "sharded_grouped"),
])
def test_dispatch_fall_through(monkeypatch, size, msm, shard, kind):
    """The reference's _dispatch_limbs fall-through: windows when D
    divides NUM_WINDOWS, else the point-sharded forest when D divides the
    total windows, else the presorted scan, whose sorted entries pad to a
    multiple of D with identity entries in the last segment; mesh_shard
    forces a kind where it applies, msm="scan" goes to the scan."""
    seen = {}

    def record(name):
        def fn(mesh, *args, stats=None, **kwargs):
            seen["kind"], seen["args"], seen["kwargs"] = name, args, kwargs
            if stats is not None:
                stats["point_adds"] = 1
            return torch.zeros(1, dtype=torch.int32)
        return fn

    for name in ("sharded_forest_by_windows",
                 "sharded_forest_window_totals",
                 "sharded_window_totals_presorted"):
        monkeypatch.setattr(pmesh, name, record(name))
    from halo2_verifier_tpu_torch.protocol.kzg import ParamsKZG

    bv = BatchVerifier(ParamsKZG(8, 256, G1_GEN, G2_GEN, G2_GEN), None,
                       mesh=_fake_mesh(size), msm=msm, mesh_shard=shard)
    s, x, y, _p, _s = _case()
    handle = bv._dispatch_limbs(s, x, y, SIZES)
    assert handle[0] == kind
    assert seen["kind"] == {
        "sharded_windows": "sharded_forest_by_windows",
        "sharded_forest": "sharded_forest_window_totals",
        "sharded_grouped": "sharded_window_totals_presorted"}[kind]
    if kind == "sharded_grouped":
        xs, _ys, idx, keys = seen["args"]
        m = 40 * 32
        assert idx.shape[0] == m + (-m) % size and idx.shape[0] % size == 0
        assert seen["kwargs"]["total_windows"] == 64
        if m % size:
            assert xs.shape[0] == 41 and not xs[-1].any()
            assert (idx[m:] == 40).all() and (keys[m:] == keys[m - 1]).all()


def test_world_of_one_equals_single_device():
    """With no group a mesh is a world of one: both forest kinds give the
    single-device forest's window totals bit for bit (one group, so a
    plan of 32 windows)."""
    s, x, y, _p, _s = _case()
    s, x, y = s[:20], x[:20], y[:20]
    want = msm_forest.dispatch_planned(
        x, y, msm_forest.host_plan(s, [20]), CPU).numpy()
    mesh = pmesh.make_mesh(1, device="cpu")
    for got in (pmesh.sharded_forest_by_windows(mesh, x, y, s, [20]),
                pmesh.sharded_forest_window_totals(mesh, x, y, s, [20])):
        assert got.shape == (1, 3, 16, 32)
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_mesh_forest_kinds_use_the_shared_chain(monkeypatch):
    """Both forest kinds build their bucket grid with
    msm_forest.forest_grid and reduce it with msm_forest.plane_reduce,
    the single-device chain's two halves, once each; in a world of one
    (no ranks) their totals are dispatch_planned's."""
    s, x, y, _p, _s = _case()
    s, x, y = s[:12], x[:12], y[:12]
    want = msm_forest.dispatch_planned(
        x, y, msm_forest.host_plan(s, [12]), CPU).numpy()
    calls = []

    def spy(name):
        real = getattr(msm_forest, name)

        def fn(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return fn

    for name in ("forest_grid", "plane_reduce"):
        monkeypatch.setattr(msm_forest, name, spy(name))
    mesh = pmesh.make_mesh(1, device="cpu")
    for kind in (pmesh.sharded_forest_by_windows,
                 pmesh.sharded_forest_window_totals):
        calls.clear()
        got = kind(mesh, x, y, s, [12])
        assert calls == ["forest_grid", "plane_reduce"], kind.__name__
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_indivisible_mesh_and_bad_arguments_raise():
    s, x, y, _p, _s = _case()
    with pytest.raises(ValueError, match="does not divide the 32"):
        pmesh.sharded_forest_by_windows(_fake_mesh(3), x, y, s, SIZES)
    with pytest.raises(ValueError, match="does not divide the 64"):
        pmesh.sharded_forest_window_totals(_fake_mesh(3), x, y, s, SIZES)
    with pytest.raises(ValueError, match="unknown upload"):
        pmesh.sharded_forest_by_windows(_fake_mesh(1), x, y, s, SIZES,
                                        upload="broadcast")
    idx, keys, levels = msm_scan.host_plan(s, SIZES)
    with pytest.raises(ValueError, match="do not split over 3"):
        pmesh.sharded_window_totals_presorted(
            _fake_mesh(3), x, y, idx[:-1], keys[:-1], 64, levels)
    with pytest.raises(ValueError, match="out of range"):
        pmesh.sharded_window_totals_presorted(
            _fake_mesh(1), x[:10], y[:10], idx, keys, 64, levels)
    with pytest.raises(ValueError, match="pad_entries"):
        pmesh.sharded_window_totals(_fake_mesh(3), s[:40], x, y)
    from halo2_verifier_tpu_torch.protocol.kzg import ParamsKZG

    params = ParamsKZG(8, 256, G1_GEN, G2_GEN, G2_GEN)
    with pytest.raises(ValueError, match="mesh_shard"):
        BatchVerifier(params, None, mesh=_fake_mesh(1), mesh_shard="rows")
    with pytest.raises(ValueError, match="mesh_upload"):
        BatchVerifier(params, None, mesh=_fake_mesh(1), mesh_upload="all")


def test_pad_entries():
    s, x, y, _p, _s = _case()
    arrs = [a[:10] for a in (s, x, y)]
    out = pmesh.pad_entries(*arrs, 4)
    for a, o in zip(arrs, out):
        assert o.shape == (12, 16)
        assert (o[:10] == a).all() and not o[10:].any()
    assert all(o is a for a, o in zip(arrs, pmesh.pad_entries(*arrs, 5)))
