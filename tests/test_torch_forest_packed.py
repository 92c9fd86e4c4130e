"""PyTorch port, the forest MSM's dispatch
(halo2_verifier_tpu_torch/ops/msm_forest.py: pin_plan_widths,
packed_layout, pack_operands, forest_grid, plane_reduce, packed_chain,
dispatch_planned) against the JAX package's accelerator dispatch, at
tests/test_msm_forest.py's shapes (pts20; [8, 12] random, [10, 10]
edges): pinned plans equal array for array over a sequence with a re-pin,
the packed buffer and its offsets equal the reference's
_dispatch_fuse3_packed, the window totals on the CPU are bit-equal to the
reference's dispatch_planned_fuse3 (its packed default) on the same
plans, fresh and pinned, and a hand-built plan's to its dispatch_planned;
the bucket grid holds the host's bucket sums, and each step of the
reduction equals the reference's."""

import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu.ops import msm_forest as jforest
from halo2_verifier_tpu_torch.ops import curve, kernels, msm_forest
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs
from halo2_verifier_tpu_torch.utils.metrics import StageTimings

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pts20():
    return [jhc.g1_mul(G1_GEN, 3 + i) for i in range(20)]


def _random_scalars(n, seed):
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def _limbs(scalars, pts):
    xs = [0 if p is None else p[0] for p in pts]
    ys = [0 if p is None else p[1] for p in pts]
    return (ints_to_limbs([s % R for s in scalars]), ints_to_limbs(xs),
            ints_to_limbs(ys))


# scalars, points (None = identity) and group sizes of each batch
def _batch(name, pts20):
    if name == "random":
        return _random_scalars(20, 3), pts20, [8, 12]
    if name == "random_b":
        return _random_scalars(20, 5), pts20, [8, 12]
    if name == "small":  # one nonzero window: the narrowest plan
        return [1 + i for i in range(20)], pts20, [8, 12]
    if name == "edges":
        return ([0] * 6 + [5] * 4 + [R - 1] * 10,
                [None] * 3 + pts20[:17], [10, 10])
    if name == "edges_small":
        return [1 + i for i in range(20)], [None] * 3 + pts20[:17], [10, 10]
    raise KeyError(name)


def _plans(name, pts20):
    """The same batch planned by both packages: (port plan, JAX plan,
    x limbs, y limbs)."""
    sc, pts, sizes = _batch(name, pts20)
    s_np, x_np, y_np = _limbs(sc, pts)
    return (msm_forest.host_plan(s_np, sizes), jforest.host_plan(s_np, sizes),
            x_np, y_np)


def _assert_plans_equal(a, b):
    for key in ("tw", "n_pad", "entries", "adds", "window_lo"):
        assert a[key] == b[key], key
    np.testing.assert_array_equal(a["point_idx0"], b["point_idx0"])
    assert len(a["levels"]) == len(b["levels"])
    for (al, ar), (bl, br) in zip(a["levels"], b["levels"]):
        np.testing.assert_array_equal(al, bl)
        np.testing.assert_array_equal(ar, br)
    assert len(a["finished"]) == len(b["finished"])
    for (alv, ap, ak), (blv, bp, bk) in zip(a["finished"], b["finished"]):
        assert alv == blv
        np.testing.assert_array_equal(ap, bp)
        np.testing.assert_array_equal(ak, bk)


def _widths(plan):
    return ((plan["point_idx0"].shape[0],)
            + tuple(iL.shape[0] for iL, _iR in plan["levels"]))


@pytest.mark.parametrize("sequence", [("small", "random", "random_b"),
                                      ("edges_small", "edges", "edges")])
def test_pin_plan_widths_equals_reference(sequence, pts20):
    """Three batches of one workload pinned in turn: the narrow first
    batch sets the pin, the second grows past it (a re-pin), the third
    fits; each pinned plan and pin equals the reference's."""
    pin = jpin = None
    pins = []
    for name in sequence:
        plan, jplan, _x, _y = _plans(name, pts20)
        plan, pin = msm_forest.pin_plan_widths(plan, pin)
        jplan, jpin = jforest.pin_plan_widths(jplan, jpin)
        assert pin == jpin
        _assert_plans_equal(plan, jplan)
        assert pin[0] == _widths(plan)  # every width padded to the pin
        pins.append(pin)
    assert pins[0] != pins[1] and pins[1] == pins[2]
    # a pin wider at every level: each level's pad rows are identity adds,
    # counted in the plan's adds as the reference counts them
    plan, jplan, _x, _y = _plans(sequence[1], pts20)
    wide = (tuple(w + 256 for w in pins[1][0]),
            tuple(w + 256 for w in pins[1][1]))
    natural_adds = plan["adds"]
    plan, pin = msm_forest.pin_plan_widths(plan, wide)
    jplan, _ = jforest.pin_plan_widths(jplan, wide)
    assert pin == wide
    _assert_plans_equal(plan, jplan)
    assert plan["adds"] == natural_adds + 256 * len(plan["levels"])


def _reference_packed(monkeypatch, x_np, y_np, jplan):
    """The reference's _dispatch_fuse3_packed with its three stage
    programs replaced by recorders: its one packed buffer and the static
    offsets it hands each stage."""
    seen = {"levels": []}

    def head(buf, *, n_pad, w0):
        seen["buf"] = np.asarray(buf)
        seen["head"] = (n_pad, w0)
        return "f"

    def levels3(f, buf, *, offs, concat_gather=False):
        seen["levels"].extend(offs)
        return f, ("p",) * len(offs)

    def tail(f_last, parts, buf, *, pos_off, scat_off, tw, bucket_scan):
        seen["tail"] = (pos_off, scat_off, tw)
        return "totals"

    monkeypatch.setattr(jforest, "_stage_head_p", head)
    monkeypatch.setattr(jforest, "_stage_levels3_p", levels3)
    monkeypatch.setattr(jforest, "_stage_tail_p", tail)
    assert jforest._dispatch_fuse3_packed(x_np, y_np, jplan) == "totals"
    return seen


@pytest.mark.parametrize("case", ["random", "edges", "pinned"])
def test_packed_layout_equals_reference(case, pts20, monkeypatch):
    """Same plan: the port's layout holds the reference's offsets
    (_dispatch_fuse3_packed, ops/msm_forest.py:747-767) and its packed
    buffer is the reference's, word for word."""
    if case == "pinned":
        first, jfirst, _x, _y = _plans("random", pts20)
        _, pin = msm_forest.pin_plan_widths(first)
        plan, jplan, x_np, y_np = _plans("small", pts20)
        plan, _ = msm_forest.pin_plan_widths(plan, pin)
        jplan, _ = jforest.pin_plan_widths(jplan, pin)
    else:
        plan, jplan, x_np, y_np = _plans(case, pts20)
    seen = _reference_packed(monkeypatch, x_np, y_np, jplan)
    layout = msm_forest.packed_layout(plan)
    L = len(plan["levels"])
    assert seen["head"] == (layout.n_pad, layout.w0)
    assert tuple(seen["levels"]) == tuple(zip(layout.levels,
                                              layout.parts[:L]))
    assert seen["tail"] == (layout.parts[L], layout.scatter, layout.tw)
    buf = np.empty(layout.total, dtype=np.int32)
    buf[:] = -1
    msm_forest.pack_operands(x_np, y_np, plan, layout, buf)
    assert seen["buf"].dtype == np.uint32
    np.testing.assert_array_equal(buf.view(np.uint32), seen["buf"])


@pytest.fixture(scope="module")
def reference_fuse3(pts20):
    """The reference's dispatch_planned_fuse3 (its packed default) on the
    [8, 12] random batch, fresh, and on the narrow batch pinned at the
    fresh batch's widths: one set of stage programs compiles for both."""
    import os

    assert os.environ.get("H2V_FOREST_PACK", "1") != "0"
    out = {}
    first, jfirst, x_np, y_np = _plans("random", pts20)
    _, pin = msm_forest.pin_plan_widths(first)
    small, jsmall, _x, _y = _plans("small", pts20)
    plans = {"fresh": (first, jfirst),
             "pinned": (msm_forest.pin_plan_widths(small, pin)[0],
                        jforest.pin_plan_widths(jsmall, pin)[0])}
    for name, (plan, jplan) in plans.items():
        _assert_plans_equal(plan, jplan)
        want = np.asarray(jforest.dispatch_planned_fuse3(x_np, y_np, jplan))
        out[name] = (plan, x_np, y_np, want)
    return out


@pytest.mark.parametrize("case", ["fresh", "pinned"])
def test_fuse3_on_cpu_equals_reference(case, reference_fuse3):
    """The port's dispatch_planned on the CPU (the packed chain on the
    plain versions) is bit-equal to the reference's
    dispatch_planned_fuse3, projective coordinates included."""
    plan, x_np, y_np, want = reference_fuse3[case]
    timings = StageTimings()
    got = msm_forest.dispatch_planned(x_np, y_np, plan, CPU,
                                      timings=timings)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert set(timings.totals) == {"dispatch_check", "dispatch_pack",
                                   "dispatch_launch"}


def test_non_canonical_plan_is_canonicalized(pts20):
    """A hand-built plan (the numpy planner's, not canonicalized) of 8
    levels whose finished parts skip levels 3-7: dispatch_planned runs the
    one chain on a canonical copy (the caller's plan is left as it was),
    and its totals are bit-equal to the reference's dispatch_planned on
    the plan as built."""
    sc = [7] * 160 + _random_scalars(20, 3)  # 160 equal keys: 8 levels
    s_np, x_np, y_np = _limbs(sc, pts20 * 8 + pts20)
    plan = msm_forest.host_plan_np(s_np, [160, 20])
    jplan = jforest.host_plan_np(s_np, [160, 20])
    _assert_plans_equal(plan, jplan)
    levels = [lvl for lvl, _pos, _keys in plan["finished"]]
    assert len(plan["levels"]) == 8 and levels == [0, 1, 2, 8]
    want = np.asarray(jforest.dispatch_planned(x_np, y_np, jplan))
    got = msm_forest.dispatch_planned(x_np, y_np, plan, CPU)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert len(plan["levels"]) == 8
    assert [lvl for lvl, _pos, _keys in plan["finished"]] == levels


@pytest.mark.parametrize("index", ["level", "scatter_key"])
def test_fuse3_checks_the_plan_before_packing(index, pts20, monkeypatch):
    """An index outside its frontier, or a scatter key outside the
    bucket grid (the kernel's scatter lanes write by key unchecked),
    raises before any operand is packed."""
    plan, _jplan, x_np, y_np = _plans("random", pts20)
    if index == "level":
        plan["levels"][0][1][0] = plan["point_idx0"].shape[0]
    else:
        plan["finished"][1][2][0] = plan["tw"] * msm_forest.NUM_BUCKETS + 1
    monkeypatch.setattr(msm_forest, "pack_operands",
                        lambda *a: pytest.fail("packed an unchecked plan"))
    with pytest.raises(ValueError, match="out of range"):
        msm_forest.dispatch_planned(x_np, y_np, plan, CPU)


def test_fuse3_on_cuda_needs_the_callers_recordings(pts20):
    """On a CUDA device the chain records into a ForestRecordings the
    caller owns; without one the dispatch raises before any device work
    (no process-wide recording cache)."""
    plan, _jplan, x_np, y_np = _plans("random", pts20)
    with pytest.raises(ValueError, match="recordings="):
        msm_forest.dispatch_planned(x_np, y_np, plan, torch.device("cuda"))


@pytest.mark.parametrize("max_slots", [0, -1])
def test_recordings_need_at_least_one_slot(max_slots):
    """A ForestRecordings holds at most max_slots recordings (4 unless
    asked), so it needs room for one."""
    assert msm_forest.ForestRecordings().max_slots == 4
    with pytest.raises(ValueError, match="max_slots"):
        msm_forest.ForestRecordings(max_slots=max_slots)


def test_recorded_launches_are_counted_per_replay():
    """Under a capture the wrappers' launches go to the tally, not the
    counters; each replay adds the tally once; other threads count as
    before."""
    import threading

    kernels.reset_launches()
    with kernels.recorded_launches() as tally:
        kernels._count("forest_frontier0", 8, ())
        kernels._count("point_add", 4, ())
        kernels._count("point_add", 2, ())
        other = threading.Thread(target=kernels._count,
                                 args=("point_add", 1, ()))
        other.start()
        other.join()
    assert tally == {"forest_frontier0": (1, 8), "point_add": (2, 6)}
    assert kernels.LAUNCHES["point_add"] == 1
    assert kernels.LAUNCHES["forest_frontier0"] == 0
    for _ in range(3):
        kernels.count_replay(tally)
    assert kernels.LAUNCHES["forest_frontier0"] == 3
    assert kernels.LAUNCHES["point_add"] == 7
    assert kernels.LANES["point_add"] == 19
    kernels._count("point_add", 1, ())  # outside a capture: counted
    assert kernels.LAUNCHES["point_add"] == 8
    kernels.reset_launches()


def _frontiers(plan, x_np, y_np):
    """Every frontier of a plan's forest on the plain versions."""
    xs, ys = msm_forest.pad_transpose_points(x_np, y_np, plan["n_pad"])
    f = [msm_forest.frontier0(torch.from_numpy(xs.view(np.int32)),
                              torch.from_numpy(ys.view(np.int32)),
                              torch.from_numpy(plan["point_idx0"]))]
    for iL, iR in plan["levels"]:
        f.append(curve.masked_add(f[-1], f[-1], iL=torch.from_numpy(iL),
                                  iR=torch.from_numpy(iR)))
    return f


def test_forest_grid_matches_host_bucket_sums(pts20):
    """forest_grid on a small plan (identities, zero digits, ten equal
    scalars: several levels): each bucket's slot is the host sum of the
    points whose digit lands there, and every slot no entry reaches is
    the identity (0 : R : 0), limb for limb."""
    sc, pts, sizes = _batch("edges", pts20)
    s_np, x_np, y_np = _limbs(sc, pts)
    plan = msm_forest.host_plan(s_np, sizes)
    assert len(plan["levels"]) >= 3
    xs, ys = msm_forest.pad_transpose_points(x_np, y_np, plan["n_pad"])
    t = torch.from_numpy
    grid = msm_forest.forest_grid(
        t(xs.view(np.int32)), t(ys.view(np.int32)), t(plan["point_idx0"]),
        [(t(iL), t(iR)) for iL, iR in plan["levels"]],
        [(t(pos), t(keys)) for _lvl, pos, keys in plan["finished"]],
        plan["tw"])
    nb, nw = msm_forest.NUM_BUCKETS, msm_forest.NUM_WINDOWS
    assert tuple(grid.shape) == (3, 16, plan["tw"] * nb + 1)
    want = {}  # slot -> host sum of its points
    for i, (s, p) in enumerate(zip(sc, pts)):
        group = 0 if i < sizes[0] else 1
        for w in range(nw):
            digit = (s >> (msm_forest.WINDOW_BITS * w)) & (nb - 1)
            if digit:
                key = (group * nw + w) * nb + digit
                want[key] = hc.g1_add(want.get(key), p)
    keys = sorted(want)
    got = curve.to_affine_host(tuple(c[:, keys] for c in grid))
    assert got == [want[k] for k in keys]
    empty = torch.ones(grid.shape[2] - 1, dtype=torch.bool)
    empty[keys] = False
    identity = msm_forest._identity_grid(plan["tw"])[:, :, :1]
    assert torch.equal(grid[:, :, :-1][:, :, empty],
                       identity.expand(-1, -1, int(empty.sum())))


@pytest.fixture(scope="module")
def grids(pts20):
    """A random canonical plan's frontiers with (0, 0, 0) entries put
    where its first two finished parts read, and its bucket grid both
    ways: (frontiers, plan, the grid a plain gather and scatter writes:
    every part gathered, concatenated and scattered into a zero grid,
    the slots that read Y = Z = 0 patched to Y = R, the (3, 16, tw * 256
    + 1) grid that the packed chain's scatter lanes write part by part
    into the identity grid)."""
    plan, _jplan, x_np, y_np = _plans("random", pts20)
    f = _frontiers(plan, x_np, y_np)
    for lvl, pos, _keys in plan["finished"][:2]:
        f[lvl] = tuple(c.clone() for c in f[lvl])
        for c in f[lvl]:
            c[:, torch.from_numpy(pos[:2]).long()] = 0
    fin = torch.stack([torch.cat([f[lvl][c].index_select(
        1, torch.from_numpy(pos).long()) for lvl, pos, _k in plan["finished"]],
        dim=1) for c in range(3)])
    keys = torch.from_numpy(np.concatenate(
        [k for _lvl, _pos, k in plan["finished"]])).long()
    dump = plan["tw"] * msm_forest.NUM_BUCKETS
    old = torch.zeros((3, 16, dump + 1), dtype=torch.int32)
    old[:, :, keys] = fin
    old = old[:, :, :dump]
    empty = (old[1] == 0).all(0) & (old[2] == 0).all(0)
    old[1][:, empty] = msm_forest._identity_grid(1)[1, :, :1]
    new = msm_forest._identity_grid(plan["tw"])
    for lvl, pos, k in plan["finished"]:
        msm_forest.scatter_part_plain(f[lvl], torch.from_numpy(pos),
                                      torch.from_numpy(k), tuple(new))
    return f, plan, old, new


def _jax(rows):
    import jax.numpy as jnp

    return tuple(jnp.asarray(c.numpy().view(np.uint32)) for c in rows)


def _from_jax(rows):
    return tuple(torch.from_numpy(np.asarray(c).astype(np.int32))
                 for c in rows)


@pytest.mark.parametrize("step", ["part_scatter", "leaf_fold", "pair_fold",
                                  "horner"])
def test_packed_chain_steps_equal_the_flat_sequence(step, grids):
    """Each plain body of the chain's launches on a random canonical
    plan: part_scatter, the parts written one by one into the identity
    grid with the Y := R patch (duplicate dump keys, (0, 0, 0) entries),
    against a gather of every part and one scatter; leaf_fold, the first
    fold by the leaf index pairs, against the reference's _fold_pairs on
    the gathered leaves (their first 8,192, to keep its compile small);
    pair_fold, a later fold by cached pair indices, against _fold_pairs;
    horner, _horner (the first doubling by index, every plane by index),
    against the reference's _horner_bits."""
    f, plan, old, new = grids
    tw = plan["tw"]
    dump = tw * msm_forest.NUM_BUCKETS
    if step == "part_scatter":
        keys = np.concatenate([k for _lvl, _pos, k in plan["finished"]])
        assert (keys == dump).sum() > 1
        zeroed = plan["finished"][0][2][:2]
        assert torch.equal(new[:, :, zeroed], msm_forest._identity_grid(
            tw)[:, :, :2])
        assert torch.equal(new[:, :, :dump], old)
        return
    if step == "leaf_fold":
        leaf = torch.from_numpy(msm_forest._bucket_leaf_idx(tw)).long()
        want = jforest._fold_pairs(_jax(c.index_select(1, leaf[:8192])
                                        for c in old))
        iL, iR = msm_forest._leaf_pairs(tw)
        got = tuple(c[:, :4096] for c in curve.masked_add(
            tuple(new), tuple(new), iL=iL, iR=iR))
    elif step == "pair_fold":
        rows = tuple(c[:, 100:100 + 8192].contiguous() for c in old)
        want = jforest._fold_pairs(_jax(rows))
        iL, iR = msm_forest._pair_idx(8192)
        got = curve.masked_add(rows, rows, iL=iL, iR=iR)
    else:
        planes = tuple(c[:, 37:37 + tw * msm_forest.WINDOW_BITS].contiguous()
                       for c in old)
        want = torch.from_numpy(np.asarray(jforest._horner_bits(
            _jax(planes), tw)).astype(np.int32))
        got = msm_forest._horner(planes, tw)
        assert got.shape == (3, 16, tw)
        assert torch.equal(got, want)
        return
    assert all(torch.equal(g, w) for g, w in zip(got, _from_jax(want)))
