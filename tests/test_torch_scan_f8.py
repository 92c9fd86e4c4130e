"""PyTorch port, scan MSM on 8-bit limbs (halo2_verifier_tpu_torch/ops/
msm_scan.py, backend="f8"): the window totals are bit-equal to the
re-limbed u16 totals and to the JAX package's f8 totals on the same plan
and points (tolerance 0), and combine to the exact host MSM.

The JAX side runs eagerly (jax.disable_jit(), with lax.fori_loop as a
Python loop over int32 indices, the index type its traced loop has): the
jitted f8 graph compiles for minutes on the CPU. One group of 20 points
keeps the bucket grid at 32 x 256."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu.ops import msm_jax
from halo2_verifier_tpu_torch import weights
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import msm_scan
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs
from halo2_verifier_tpu_torch.ops.msm import combine_window_totals_grouped

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """20 points with a zero scalar, an identity and a duplicate, one
    group; the plan, and the port's totals in both formats."""
    pts = [jhc.g1_mul(G1_GEN, 3 + i) for i in range(20)]
    rng = np.random.RandomState(3)
    sc = [int.from_bytes(rng.bytes(32), "little") % R for _ in pts]
    sc[0], pts[1], pts[4] = 0, None, pts[3]
    s_np = ints_to_limbs(sc)
    x_np = ints_to_limbs([0 if p is None else p[0] for p in pts])
    y_np = ints_to_limbs([0 if p is None else p[1] for p in pts])
    idx, keys, levels = msm_scan.host_plan(s_np, [20])
    totals = {
        be: msm_scan.msm_window_totals_grouped(
            x_np, y_np, idx, keys, 1, levels, CPU, backend=be).numpy()
        for be in ("u16", "f8")
    }
    return sc, pts, (x_np, y_np, idx, keys, levels), totals


def test_f8_totals_are_the_relimbed_u16_totals(case):
    sc, pts, _plan, totals = case
    assert totals["f8"].dtype == np.float32
    assert totals["f8"].shape == (3, 32, 32)
    np.testing.assert_array_equal(
        totals["f8"], weights.limbs16_to_limbs8(totals["u16"]))
    np.testing.assert_array_equal(
        weights.limbs8_to_limbs16(totals["f8"]), totals["u16"])
    assert totals["f8"].min() >= 0 and totals["f8"].max() <= 255


@pytest.mark.parametrize("backend", ["u16", "f8"])
def test_totals_combine_to_host_msm(case, backend):
    sc, pts, _plan, totals = case
    assert combine_window_totals_grouped(totals[backend], 1) == [
        hc.g1_msm(sc, pts)]


def test_f8_totals_equal_reference(case, monkeypatch):
    _sc, _pts, (x_np, y_np, idx, keys, levels), totals = case

    def fori_loop(lower, upper, body, val):
        for i in range(lower, upper):
            val = body(jnp.int32(i), val)
        return val

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        want = np.asarray(msm_jax.msm_window_totals_grouped(
            x_np, y_np, idx, keys, 1, levels, backend="f8"))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(totals["f8"], want)
