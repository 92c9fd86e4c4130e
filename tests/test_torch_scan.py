"""PyTorch port, scan MSM (halo2_verifier_tpu_torch/ops/msm_scan.py):
plans equal to the JAX package's, segment ends, and u16 window totals
bit-equal to msm_jax.msm_window_totals_grouped on the same points
(tolerance 0). tests/test_torch_scan_msm.py holds the scan MSM against
the exact host MSM, tests/test_torch_scan_f8.py the 8-bit-limb backend.

The JAX side runs eagerly (jax.disable_jit(), with lax.fori_loop as a
Python loop over int32 indices, the index type its traced loop has): the
jitted graph compiles for minutes on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu.ops import msm_jax
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


@pytest.fixture
def eager_jax(monkeypatch):
    """Run the JAX package's scan eagerly, as its traced form computes:
    the traced loop index is an int32, so the level offset
    `uint32(1) << k` is a signed value and `-offset` rolls backwards."""

    def fori_loop(lower, upper, body, val):
        for i in range(lower, upper):
            val = body(jnp.int32(i), val)
        return val

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        yield


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


@pytest.mark.parametrize("case", ["random", "equal", "edges", "single",
                                  "int_groups", "nine_groups"])
def test_host_plan_equals_reference(case):
    sc, groups = {
        "random": (_random_scalars(40, 23), [15, 25]),
        "equal": ([7] * 20, [20]),
        "edges": ([0] * 6 + [5] * 4 + [R - 1] * 10, [10, 10]),
        "single": ([1], [1]),
        "int_groups": (_random_scalars(24, 5), 3),
        "nine_groups": (_random_scalars(27, 6), 9),  # keys past 16 bits
    }[case]
    limbs = ints_to_limbs([s % R for s in sc])
    idx, keys, levels = msm_scan.host_plan(limbs, groups)
    jidx, jkeys, jlevels = msm_jax.host_plan(limbs, groups)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(keys, jkeys)
    assert (idx.dtype, keys.dtype, levels) == (jidx.dtype, jkeys.dtype,
                                               jlevels)
    assert msm_scan._scan_levels(limbs) == msm_jax._scan_levels(limbs)


def test_segment_ends_host_and_device_agree():
    limbs = ints_to_limbs(_random_scalars(40, 7) + [0, 0])
    _idx, keys, _levels = msm_scan.host_plan(limbs, [20, 22])
    pos = msm_scan.segment_ends(keys, 64)
    dev = msm_scan._segment_ends_device(
        torch.from_numpy(keys.view(np.int32)), 64)
    np.testing.assert_array_equal(pos, dev.numpy())
    filled = pos[pos >= 0]
    assert np.array_equal(np.sort(np.unique(keys)), np.flatnonzero(pos >= 0))
    assert np.all(keys[filled] == np.flatnonzero(pos >= 0))
    assert np.all((filled == len(keys) - 1) | (keys[filled] != keys[
        np.minimum(filled + 1, len(keys) - 1)]))


def test_u16_window_totals_equal_reference(pts20, eager_jax):
    """Same plan, same points: the (3, 16, 64) window-totals arrays are
    bit-equal, projective coordinates included."""
    sc = _random_scalars(20, 3)
    s_np, x_np, y_np = _limbs(sc, pts20)
    idx, keys, levels = msm_scan.host_plan(s_np, [8, 12])
    want = np.asarray(msm_jax.msm_window_totals_grouped(
        x_np, y_np, idx, keys, 2, levels, backend="u16"))
    got = msm_scan.msm_window_totals_grouped(x_np, y_np, idx, keys, 2,
                                             levels, CPU)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert combine_window_totals_grouped(got.numpy(), 2) == [
        hc.g1_msm(sc[:8], pts20[:8]), hc.g1_msm(sc[8:], pts20[8:])]


def test_plan_index_check_and_backend_name(pts20):
    s_np, x_np, y_np = _limbs(_random_scalars(20, 4), pts20)
    idx, keys, levels = msm_scan.host_plan(s_np, [8, 12])
    bad = idx.copy()
    bad[0] = 20
    with pytest.raises(ValueError):
        msm_scan.msm_window_totals_grouped(x_np, y_np, bad, keys, 2, levels,
                                           CPU)
    with pytest.raises(ValueError):
        msm_scan.msm_window_totals_grouped(x_np, y_np, idx, keys, 2, levels,
                                           CPU, backend="u32")
    assert msm_scan.scan_lanes(640, 64, 2) == 2 * 640 + 16 * 64 * 255
