"""PyTorch port, 8-bit-limb field layer (halo2_verifier_tpu_torch/ops/
field8.py): every plain body against the JAX package's lmfield8 body on
the same numpy inputs, bit for bit (tolerance 0: the limbs are integers),
for Fq and Fr at B = 64 with the adversarial operands of
tests/test_lm8_kernels.py; carry_full on 255-ripple chains; the constants;
expand16_to8 and the host re-limbing pair of weights.py; the float-bit
identities the card's kernels pack and unpack this format with."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import lmfield8 as l8
from halo2_verifier_tpu.ops.field_jax import FQ as JFQ, FR as JFR
from halo2_verifier_tpu_torch import weights
from halo2_verifier_tpu_torch.ops import field8 as f8
from halo2_verifier_tpu_torch.ops.constants import P, R
from halo2_verifier_tpu_torch.ops.field import FQ, FR
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs

SPECS = [(FQ, JFQ, P), (FR, JFR, R)]
IDS = ["fq", "fr"]
B = 64


def _operands(mod, seed):
    rng = np.random.default_rng(seed)

    def rand():
        v = 1
        for _ in range(5):
            v = v * int(rng.integers(1, 1 << 60)) % mod
        return v

    avals = [rand() for _ in range(B)]
    bvals = [rand() for _ in range(B)]
    # adversarial: identities, wrap-around neighbours, Montgomery one
    avals[:6] = [0, 1, mod - 1, mod - 2, (1 << 256) % mod,
                 ((1 << 256) - 1) % mod]
    bvals[:6] = [0, mod - 1, mod - 1, 1, 2, ((1 << 255) - 1) % mod]
    return avals, bvals


def _arr(vals):
    return np.stack([f8.int_to_limbs8(v) for v in vals], axis=1)


def _ints(a):
    a = np.asarray(a)
    return [f8.limbs8_to_int(a[:, i]) for i in range(a.shape[1])]


def _eq(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_limb_codecs_match_reference():
    for v in (0, 1, P - 1, R - 1, (1 << 256) - 1, 0x0123456789ABCDEF << 64):
        np.testing.assert_array_equal(f8.int_to_limbs8(v),
                                      l8.int_to_limbs8(v))
        assert f8.limbs8_to_int(f8.int_to_limbs8(v)) == v
        assert l8.limbs8_to_int(f8.int_to_limbs8(v)) == v


@pytest.mark.parametrize("spec,jspec,mod", SPECS, ids=IDS)
def test_mont_mul_body_matches_reference(spec, jspec, mod):
    avals, bvals = _operands(mod, 0)
    a, b = _arr(avals), _arr(bvals)
    got = f8.mont_mul_body(torch.from_numpy(a), torch.from_numpy(b), spec)
    _eq(got, l8.mont_mul_body(jnp.asarray(a), jnp.asarray(b), jspec))
    rinv = pow(1 << 256, -1, mod)
    assert _ints(got) == [x * y * rinv % mod for x, y in zip(avals, bvals)]
    # the dispatching entry takes the plain body for CPU tensors
    _eq(f8.mont_mul(torch.from_numpy(a), torch.from_numpy(b), spec), got)


@pytest.mark.parametrize("spec,jspec,mod", SPECS, ids=IDS)
def test_add_sub_neg_bodies_match_reference(spec, jspec, mod):
    avals, bvals = _operands(mod, 1)
    a, b = _arr(avals), _arr(bvals)
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    got = f8.add_body(ta, tb, spec)
    _eq(got, l8.add_body(ja, jb, jspec))
    assert _ints(got) == [(x + y) % mod for x, y in zip(avals, bvals)]
    got = f8.sub_body(ta, tb, spec)
    _eq(got, l8.sub_body(ja, jb, jspec))
    assert _ints(got) == [(x - y) % mod for x, y in zip(avals, bvals)]
    got = f8.neg_body(ta, spec)
    _eq(got, l8.neg_body(ja, jspec))
    assert _ints(got) == [(-x) % mod for x in avals]
    _eq(f8.cond_sub_n(ta, spec), l8.cond_sub_n(ja, jspec))


def test_carry_fold_and_carry_full_on_ripple_chains():
    """carry_full equals the value mod 2^256 with canonical limbs, on
    adversarial 255-ripple chains, and both carries equal the
    reference's."""
    rng = np.random.default_rng(1)
    cols = []
    for trial in range(200):
        x = rng.integers(0, 1 << 22, size=32).astype(np.float32)
        if trial % 3 == 1:
            x[rng.random(32) < 0.5] = 255.0
        if trial % 3 == 2:
            x[:] = 255.0
            x[0] = float(rng.integers(256, 1 << 22))
        cols.append(x)
    x = np.stack(cols, axis=1)  # (32, 200)
    got = f8.carry_full(torch.from_numpy(x))
    _eq(got, l8.carry_full(jnp.asarray(x)))
    assert float(got.max()) <= 255 and float(got.min()) >= 0
    vals = [sum(int(x[k, i]) << (8 * k) for k in range(32))
            for i in range(x.shape[1])]
    assert _ints(got) == [v % (1 << 256) for v in vals]
    for passes in (1, 2, 3):
        _eq(f8.carry_fold(torch.from_numpy(x), passes),
            l8.carry_fold(jnp.asarray(x), passes))


@pytest.mark.parametrize("spec,jspec,mod", SPECS, ids=IDS)
def test_constants_select_is_zero_match_reference(spec, jspec, mod):
    _eq(f8.mont_one(spec, 3, torch.device("cpu")), l8.mont_one(jspec, 3))
    assert _ints(f8.col(spec, "r2", "cpu")) == [spec.mont_r2]
    assert _ints(f8.col(spec, "n", "cpu")) == [mod]
    avals, bvals = _operands(mod, 2)
    a, b = _arr(avals), _arr(bvals)
    cond = np.arange(B) % 3 == 0
    _eq(f8.select(torch.from_numpy(cond), torch.from_numpy(a),
                  torch.from_numpy(b)),
        l8.select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b)))
    assert f8.is_zero(torch.from_numpy(a)).tolist() == np.asarray(
        l8.is_zero(jnp.asarray(a))).tolist() == [v == 0 for v in avals]


def test_expand16_to8_and_host_relimbing_pair():
    avals, _ = _operands(P, 3)
    u16 = np.ascontiguousarray(ints_to_limbs(avals).T)  # (16, B) uint32
    want = np.asarray(l8.expand16_to8(jnp.asarray(u16)))
    got = f8.expand16_to8(torch.from_numpy(u16.astype(np.int32)))
    _eq(got, want)
    assert _ints(got) == avals
    host = weights.limbs16_to_limbs8(u16)
    assert host.dtype == np.float32
    np.testing.assert_array_equal(host, want)
    back = weights.limbs8_to_limbs16(host)
    assert back.dtype == np.int32
    np.testing.assert_array_equal(back, u16.astype(np.int32))
    # stacked point arrays: the limb axis is the one before last
    stacked = np.stack([u16, u16[:, ::-1], u16])
    np.testing.assert_array_equal(weights.limbs16_to_limbs8(stacked)[1],
                                  weights.limbs16_to_limbs8(u16[:, ::-1]))
    np.testing.assert_array_equal(
        weights.limbs8_to_limbs16(weights.limbs16_to_limbs8(stacked)),
        stacked.astype(np.int32))


MAGIC = np.float32(8388608.0)  # 2^23: bits 0x4B000000 | x for x < 2^23


def _byte_perm(x, y, selector):
    """numpy mirror of CUDA's __byte_perm(x, y, s): byte k of the result
    is byte (s >> 4k) & 7 of the eight bytes of (y:x)."""
    x, y = np.asarray(x, np.uint32), np.asarray(y, np.uint32)
    src = [(x >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    src += [(y >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for k in range(4):
        out |= src[(selector >> (4 * k)) & 7] << np.uint32(8 * k)
    return out


def test_kernel_packing_identities_exhaustive():
    """csrc/field.cuh Limbs8, mirrored in float32: on loading,
    fmaf(l1, 256, l0 + 2^23) carries l0 + 256 l1 in its low 16 bits for
    all 65,536 limb pairs, and byte_perm(lo, hi, 0x5410) joins two halves
    into the word; on storing, byte_perm(w, 0x4B000000, 0x765k) - 2^23 is
    byte k of w as an exact float, for every byte in every position."""
    limbs = np.arange(256, dtype=np.float32)
    l0, l1 = (a.ravel() for a in np.meshgrid(limbs, limbs, indexing="ij"))
    # the fma rounds once: its exact value in float64, rounded to float32
    fma = (l1.astype(np.float64) * 256 + (l0 + MAGIC)).astype(np.float32)
    halves = fma.view(np.uint32)
    want = l0.astype(np.uint32) + 256 * l1.astype(np.uint32)
    np.testing.assert_array_equal(halves & np.uint32(0xFFFF), want)
    # two float32 steps give the same bits (every value is exact)
    np.testing.assert_array_equal(
        (l1 * np.float32(256) + (l0 + MAGIC)).view(np.uint32), halves)
    hi = halves[::-1]
    np.testing.assert_array_equal(_byte_perm(halves, hi, 0x5410),
                                  want + (want[::-1] << np.uint32(16)))
    b = np.arange(256, dtype=np.uint32)
    words = np.concatenate([b * np.uint32(0x01010101),
                            b | (b[::-1] << np.uint32(8))
                            | (b << np.uint32(16)) | (b[::-1] << np.uint32(24))])
    for k in range(4):
        f = _byte_perm(words, 0x4B000000, 0x7650 | k).view(np.float32) - MAGIC
        assert f.dtype == np.float32
        np.testing.assert_array_equal(
            f, ((words >> np.uint32(8 * k)) & np.uint32(0xFF)).astype(
                np.float32))
