"""PyTorch port, the device pairing's final exponentiation and final
product on the CPU (halo2_verifier_tpu_torch/ops/pairing.py on the plain
versions), limb for limb (tolerance 0): the hard part against the JAX
package's fq12_pow_bits over _HARD_BITS; the final exponentiation of a
seeded random Fq12, and the final-exponentiated product of tampered
pairs, against the exact host oracle (ops/hostpairing.py). The
bilinearity verdicts are in tests/test_torch_pairing_bilinearity.py.

The JAX package's _pairing_product_fn is the composition of the Miller
lanes (held against _miller_lanes_fn in tests/test_torch_pairing_check.py),
fq12_mul, fq12_conj, fq12_inv, fq12_frobenius2 (tests/test_torch_pairing.
py) and the hard part (here). XLA-CPU compiles _pairing_product_fn whole
in about 3.5 minutes on an 8-core host, so no test compiles it; the final
product is held against the oracle, whose final exponentiation computes
the same function, and so the same canonical limbs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import pairing_jax as pj
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import hostpairing as hp
from halo2_verifier_tpu_torch.ops import pairing as tp
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, G2_GEN, P, R

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g1(k):
    return hc.g1_mul(G1_GEN, k % R)


def _g2(k):
    return hc.g2_mul(G2_GEN, k % R)


def _oracle_limbs(f):
    """Oracle Fq12 (nested ints) -> (12, 16, 1) int32 Montgomery limbs in
    fq12_stack's coefficient order."""
    vals = [c for six in f for fq2 in six for c in fq2]
    return np.stack([tp.mont_cols([v]) for v in vals])


def _random_fq12(seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(12)]
    return (tuple((vals[i], vals[i + 1]) for i in (0, 2, 4)),
            tuple((vals[i], vals[i + 1]) for i in (6, 8, 10)))


def test_final_exponentiation_matches_reference_and_oracle():
    """The hard part bit-equal to pairing_jax.fq12_pow_bits over all 761
    bits of _HARD_BITS, and the whole final exponentiation equal to the
    oracle's, on a seeded random Fq12."""
    f = _random_fq12(21)
    X = torch.from_numpy(_oracle_limbs(f))  # (12, 16, 1)
    a = tp._fq12_from_stack(X.transpose(0, 1))
    got = tp.fq12_stack(tp.fq12_pow_bits(a, tp._HARD_BITS))
    want = jax.jit(lambda x: pj.fq12_stack(pj.fq12_pow_bits(
        pj._fq12_from_stack(x), pj._HARD_BITS)))(
        jnp.asarray(X.numpy().astype(np.uint32).transpose(1, 0, 2)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    got = tp.fq12_stack(tp.final_exponentiation(a))
    np.testing.assert_array_equal(
        got.numpy(), _oracle_limbs(hp.final_exponentiation(f)))


def test_pairing_product_matches_oracle():
    """The final-exponentiated product of tampered bilinearity pairs (a
    value other than one) equals the oracle's final exponentiation of the
    product of its Miller loops, limb for limb."""
    a, b = 6, 13
    pairs = [(_g1(a), _g2(b)), (hc.g1_neg(_g1(a * b + 1)), G2_GEN)]
    g1 = np.stack([tp.mont_cols([p[i] for p, _ in pairs]) for i in (0, 1)])
    g2 = np.stack([tp.mont_cols([q[i][j] for _, q in pairs])
                   for i in (0, 1) for j in (0, 1)])
    got = tp.pairing_product(torch.from_numpy(g1), torch.from_numpy(g2),
                             n=2)
    assert got.shape == (12, 16, 1) and got.dtype == torch.int32
    want = hp.final_exponentiation(hp.multi_miller_loop(pairs))
    np.testing.assert_array_equal(got.numpy(), _oracle_limbs(want))
    assert want != hp.FQ12_ONE
