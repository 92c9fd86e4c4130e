"""PyTorch port, sqrt pre-pass (halo2_verifier_tpu_torch/ops/decomp.py):
principal roots, by the square-root kernel's window schedule, bit-equal to
the JAX package's decomp_jax on a k=8 program's proof points and on seeded
x with the edge values; the schedule reproduces (q+1)/4; the kernel's
radix-2^29 arithmetic, emulated on Python integers, stays inside its
64-bit columns and lands on the canonical root; the replay VM accepts the
roots and rejects a wrong one."""

import os
import random
import re

import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import decomp_jax
from halo2_verifier_tpu_torch.ops import decomp, kernels
from halo2_verifier_tpu_torch.ops.constants import P, sqrt_edge_xs
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from halo2_verifier_tpu_torch.protocol.replay_native import (
    CompiledReplay,
    MalformedProof,
)


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
def k8_points(vm_proofs_k8):
    params, vk, batch = vm_proofs_k8
    program = CompiledReplay(params, vk, tuple(len(c) for c in batch[0][1]))
    xs = program.gather_point_xs([p for p, _ in batch])
    return program, batch, xs


def test_roots_equal_reference(k8_points):
    _program, _batch, xs = k8_points
    want = np.asarray(decomp_jax.dispatch_y_batch(xs))
    got = decomp.dispatch_y_batch(xs, torch.device("cpu"))
    assert tuple(got.shape) == want.shape == (16, decomp.PAD_GRAN)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # each real lane is a square root of x^3 + 3 up to sign
    for x, y in zip(limbs_to_ints(xs), limbs_to_ints(got.numpy().T)):
        assert (y * y - x ** 3 - 3) % P == 0


def test_vm_checks_the_roots(k8_points):
    program, batch, xs = k8_points
    y = decomp.dispatch_y_batch(xs, torch.device("cpu")).numpy()
    ext_y = CompiledReplay.pack_ext_y(y, xs.shape[0])
    items = [(p, inst) for p, inst in batch]
    assert (program.replay_batch_raw(items, ext_y=ext_y)
            == program.replay_batch_raw(items))
    bad = y.copy()
    bad[0, 1] ^= 1  # proof 0's second point gets a wrong root
    with pytest.raises(MalformedProof) as err:
        program.replay_batch_raw(
            items, ext_y=CompiledReplay.pack_ext_y(bad, xs.shape[0]))
    assert err.value.indices == [0]


@pytest.mark.parametrize("w", [1, 3, 4, 5])
def test_window_schedule_reproduces_exponent(w):
    """pow_window's digits give back (q+1)/4, and the products it runs
    (counted on Python integers) are sqrt_chain_counts' less the four
    around the exponent; the window is the kernel's."""
    assert decomp.SQRT_EXP == (P + 1) // 4
    digits = decomp.window_digits(decomp.SQRT_EXP, w)
    assert sum(d << (w * k) for k, d in enumerate(reversed(digits))) == (
        decomp.SQRT_EXP)
    counts = {"sq": 0, "mul": 0}

    def mul(a, b):
        counts["sq" if a is b else "mul"] += 1
        return a * b % P

    assert decomp.pow_window(5, decomp.SQRT_EXP, w, mul) == pow(
        5, (P + 1) // 4, P)
    sq, mu = decomp.sqrt_chain_counts(w)
    assert (counts["sq"], counts["mul"]) == (sq - 1, mu - 3)
    with open(os.path.join(kernels.CSRC_DIR, "mont_mul.cu")) as f:
        window = re.search(r"kWindow = (\d+);", f.read()).group(1)
    assert int(window) == decomp.SQRT_WINDOW


def test_roots_equal_reference_on_seeded_x():
    """The kernel's schedule over the plain bodies (y_principal_plain)
    against the reference's square-and-multiply (decomp_jax) on seeded
    canonical x, about half of them off the curve, and the edge values:
    bit for bit, and each edge lane equal to pow on Python integers."""
    edge = sqrt_edge_xs()
    rng = random.Random(4)
    vals = edge + [rng.randrange(P) for _ in range(200)]
    xs = ints_to_limbs(vals)
    want = np.asarray(decomp_jax.dispatch_y_batch(xs)).astype(np.int32)
    got = decomp.dispatch_y_batch(xs, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert limbs_to_ints(got.T[:len(edge)]) == [
        pow((x ** 3 + 3) % P, (P + 1) // 4, P) for x in edge]


# The square-root kernel's arithmetic (csrc/mont_mul.cu), step for step on
# Python integers, each 64-bit column checked against 2^64.
M29 = (1 << 29) - 1
Q29 = [(P >> (29 * j)) & M29 for j in range(9)]
QINV29 = (-pow(P, -1, 1 << 29)) % (1 << 29)


def _col(v):
    assert 0 <= v < 1 << 64
    return v


def _redc29(t):
    t = list(t)
    for i in range(9):
        m = ((t[i] & 0xFFFFFFFF) * QINV29) & M29
        for j in range(9):
            t[i + j] = _col(t[i + j] + m * Q29[j])
        t[i + 1] = _col(t[i + 1] + (t[i] >> 29))
    c = t[9:]
    u = ([c[0] & M29] + [(c[j] & M29) + (c[j - 1] >> 29) for j in range(1, 8)]
         + [c[7] >> 29])
    return ([u[0]] + [(u[j] & M29) + (u[j - 1] >> 29) for j in range(1, 8)]
            + [u[8] + (u[7] >> 29)])


def _mul29(a, b):
    t = [0] * 17
    if a is b:  # sqr29: cross products doubled
        for i in range(9):
            for j in range(i + 1, 9):
                t[i + j] = _col(t[i + j] + (a[i] << 1) * a[j])
            t[2 * i] = _col(t[2 * i] + a[i] * a[i])
    else:
        for i in range(9):
            for j in range(9):
                t[i + j] = _col(t[i + j] + a[i] * b[j])
    r = _redc29(t)
    assert max(r) < (1 << 29) + (1 << 7)
    assert _value29(r) < 2 * P
    return r


def _value29(limbs):
    return sum(v << (29 * j) for j, v in enumerate(limbs))


def _normalize29(a):
    r, c = [], 0
    for v in a[:8]:
        r.append((v + c) & M29)
        c = (v + c) >> 29
    return r + [a[8] + c]


def _limbs29(v):
    return [(v >> (29 * j)) & M29 for j in range(9)]


def _sqrt29(x):
    rp = (1 << 261) % P
    xm = _mul29(_limbs29(x), _limbs29(rp * rp % P))
    x3 = _mul29(_mul29(xm, xm), xm)
    base = _normalize29([a + b for a, b in zip(x3, _limbs29(3 * rp % P))])
    y = decomp.pow_window(base, decomp.SQRT_EXP, decomp.SQRT_WINDOW, _mul29)
    out = _value29(_normalize29(_redc29(y + [0] * 8)))
    assert out <= P
    return out - P if out >= P else out


def test_radix29_emulation_gives_the_roots():
    """The edge x values (constants.sqrt_edge_xs) and seeded ones: the
    emulated kernel returns (x^3 + 3)^((q+1)/4) mod q, and no column
    passes 2^64."""
    rng = random.Random(29)
    xs = sqrt_edge_xs() + [rng.randrange(P) for _ in range(3)]
    for x in xs:
        assert _sqrt29(x) == pow((x ** 3 + 3) % P, (P + 1) // 4, P), x
    # a product at the limbs' bound stays inside the columns
    top = [(1 << 29) + (1 << 7) - 1] * 8 + [1 << 23]
    _mul29(top, list(top))
    _mul29(top, top)
