"""PyTorch port, scan MSM against the exact host MSM
(halo2_verifier_tpu_torch/ops/msm_scan.py): msm_host (device sort, padded
to a power of two) on the cases of tests/test_curve_msm_jax.py, the
grouped presorted path on zero scalars, identities, duplicate points and
an all-zero group."""

import random

import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import msm_scan
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs
from halo2_verifier_tpu_torch.ops.msm import combine_window_totals_grouped

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers for the
    cores."""
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


@pytest.mark.parametrize("n", [1, 7, 64])
def test_msm_host_matches_host_msm(n):
    """The cases of tests/test_curve_msm_jax.py::test_msm_matches_host:
    a zero scalar, an identity point, the largest scalar, duplicate
    points; device sort, padded to a power of two."""
    rng = random.Random(99 + n)
    scalars = [rng.randrange(R) for _ in range(n)]
    points = [hc.g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    if n >= 7:
        scalars[0] = 0            # zero scalar
        points[1] = None          # identity point
        scalars[2] = R - 1        # max scalar
        points[3] = points[4]     # duplicate points
        scalars[5] = 1
    assert msm_scan.msm_host(scalars, points, CPU) == hc.g1_msm(scalars,
                                                                points)


def test_grouped_edge_cases_match_host_msm(pts20):
    """Zero scalars, identities and duplicate points in the first group;
    the second group's scalars are all zero (its sum is the identity)."""
    sc = [0] * 3 + [5] * 4 + [R - 1] * 9 + [0] * 4
    pts = [None] * 2 + pts20[:4] + [pts20[4]] * 4 + pts20[:10]
    sizes = [16, 4]
    s_np, x_np, y_np = _limbs(sc, pts)
    idx, keys, levels = msm_scan.host_plan(s_np, sizes)
    arr = msm_scan.msm_window_totals_grouped(x_np, y_np, idx, keys,
                                             len(sizes), levels, CPU)
    want, off = [], 0
    for sz in sizes:
        want.append(hc.g1_msm(sc[off:off + sz], pts[off:off + sz]))
        off += sz
    assert combine_window_totals_grouped(arr.numpy(), len(sizes)) == want
