"""PyTorch port, forest MSM (halo2_verifier_tpu_torch/ops/msm_forest.py):
plans equal to the JAX package's array for array, window totals bit-equal
to the JAX package's dispatch_planned on the shape tests/test_msm_forest.py
compiles, and affine results equal to the exact host MSM on the identity,
zero and duplicate edge cases."""

import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu.ops import msm_forest as jforest
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import msm_forest
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs
from halo2_verifier_tpu_torch.ops.msm import combine_window_totals_grouped


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


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


@pytest.mark.parametrize("case", ["random", "equal", "edges", "single"])
def test_host_plan_equals_reference(case):
    sc, sizes = {
        "random": (_random_scalars(40, 23), [15, 25]),
        "equal": ([7] * 20, [20]),
        "edges": ([0] * 6 + [5] * 4 + [R - 1] * 10, [10, 10]),
        "single": ([1], [1]),
    }[case]
    limbs = ints_to_limbs([s % R for s in sc])
    _assert_plans_equal(msm_forest.host_plan(limbs, sizes),
                        jforest.host_plan(limbs, sizes))
    # the port's numpy planner against the reference's (uncanonicalized)
    _assert_plans_equal(msm_forest.host_plan_np(limbs, sizes),
                        jforest.host_plan_np(limbs, sizes))


def test_window_totals_equal_reference(pts20):
    """Same plan, same points: the (3, 16, 64) window-totals arrays are
    bit-equal, projective coordinates included."""
    sc = _random_scalars(20, 3)
    s_np, x_np, y_np = _limbs(sc, pts20)
    want = np.asarray(jforest.dispatch_planned(
        x_np, y_np, jforest.host_plan(s_np, [8, 12])))
    got = msm_forest.dispatch_planned(
        x_np, y_np, msm_forest.host_plan(s_np, [8, 12]), CPU)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert combine_window_totals_grouped(got.numpy(), 2) == [
        hc.g1_msm(sc[:8], pts20[:8]), hc.g1_msm(sc[8:], pts20[8:])]


@pytest.mark.parametrize("case", ["zeros_identities_duplicates",
                                  "single_entry", "all_zero"])
def test_edge_cases_match_host_msm(case, pts20):
    sc, pts, sizes = {
        "zeros_identities_duplicates": (
            [0] * 6 + [5] * 4 + [R - 1] * 10,
            [None] * 3 + pts20[:17], [10, 10]),
        "single_entry": ([1], [pts20[4]], [1]),
        "all_zero": ([0] * 4, pts20[:4], [2, 2]),
    }[case]
    got = msm_forest.msm_grouped(*_limbs(sc, pts), sizes, CPU)
    want, off = [], 0
    for sz in sizes:
        want.append(hc.g1_msm(sc[off:off + sz], pts[off:off + sz]))
        off += sz
    assert got == want


def test_plan_index_check_rejects_out_of_range(pts20):
    s_np, x_np, y_np = _limbs(_random_scalars(20, 4), pts20)
    plan = msm_forest.host_plan(s_np, [8, 12])
    plan["levels"][0][1][0] = plan["point_idx0"].shape[0]
    with pytest.raises(ValueError):
        msm_forest.dispatch_planned(x_np, y_np, plan, CPU)



@pytest.mark.parametrize("case", ["points", "identities_and_pad"])
def test_frontier0_plain_equals_reference(case, pts20):
    """The level-0 frontier kernel's plain version equals the reference's
    _convert_points + _gather0 on the plan of the window-totals test:
    repeated indices, (0, 0) source lanes and the identity pad's index."""
    import jax.numpy as jnp

    pts = pts20 if case == "points" else [None] * 4 + pts20[4:]
    s_np, x_np, y_np = _limbs(_random_scalars(20, 3), pts)
    plan = msm_forest.host_plan(s_np, [8, 12])
    idx0 = plan["point_idx0"]
    assert (idx0 == plan["n_pad"] - 1).any()  # the identity pad is gathered
    xs, ys = msm_forest.pad_transpose_points(x_np, y_np, plan["n_pad"])
    want = jforest._gather0(
        jforest._convert_points(jnp.asarray(xs), jnp.asarray(ys)),
        jnp.asarray(idx0))
    args = (torch.from_numpy(xs.view(np.int32)),
            torch.from_numpy(ys.view(np.int32)), torch.from_numpy(idx0))
    got = msm_forest.frontier0_plain(*args)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int32))
    # frontier0 takes the plain version for CPU tensors
    again = msm_forest.frontier0(*args)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
