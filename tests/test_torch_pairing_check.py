"""PyTorch port, the device pairing on the CPU (halo2_verifier_tpu_torch/
ops/pairing.py on the plain versions), mirroring tests/test_pairing_jax.py:
per-lane Miller loop outputs bit-equal to the JAX package's
_miller_lanes_fn and to the exact host oracle (ops/hostpairing.py); the
identity-pair skip; the engine binds its device. The final exponentiation,
the final product and the bilinearity verdicts are in
tests/test_torch_pairing_product.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import pairing_jax as pj
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import hostpairing as hp
from halo2_verifier_tpu_torch.ops import pairing as tp
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, G2_GEN, R
from halo2_verifier_tpu_torch.protocol.kzg import (
    AccumulatorStrategy, ParamsKZG, SingleStrategy, pairing_backend)

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


def _g1(k):
    return hc.g1_mul(G1_GEN, k % R)


def _g2(k):
    return hc.g2_mul(G2_GEN, k % R)


def _lanes(pairs):
    """(g1, g2) Montgomery limb arrays of the pairs, (2|4, 16, n) int32."""
    g1 = np.stack([tp.mont_cols([p[0] for p, _ in pairs]),
                   tp.mont_cols([p[1] for p, _ in pairs])])
    g2 = np.stack([tp.mont_cols([q[0][0] for _, q in pairs]),
                   tp.mont_cols([q[0][1] for _, q in pairs]),
                   tp.mont_cols([q[1][0] for _, q in pairs]),
                   tp.mont_cols([q[1][1] for _, q in pairs])])
    return g1, g2


def test_miller_lanes_match_reference_and_oracle():
    pairs = [(_g1(3), _g2(5)), (_g1(7), _g2(11)), (_g1(1), _g2(1))]
    g1, g2 = _lanes(pairs)
    got = tp.miller_lanes(torch.from_numpy(g1), torch.from_numpy(g2))
    want = pj._miller_lanes_fn(jnp.asarray(g1.astype(np.uint32)),
                               jnp.asarray(g2.astype(np.uint32)))
    assert got.shape == (12, 16, 3) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    for i, (p, q) in enumerate(pairs):
        assert tp.fq12_from_device(got, lane=i) == hp.miller_loop(p, q)


def test_pairing_check_identity_pairs():
    """Identity G1/G2 members contribute 1 (engine skip semantics): with
    no live pair the check is true without any device work."""
    assert tp.pairing_check_device([(None, G2_GEN)], CPU) is True
    assert tp.pairing_check_device([(G1_GEN, None), (None, None)],
                                   CPU) is True
    assert tp.pairing_check_device([], CPU) is True


def test_pairing_backend_binds_device(monkeypatch):
    """pairing_backend("device", device) is the tower bound to that
    device, as the strategies bind it; with no device it is the CUDA
    card, and raises without one."""
    fn = pairing_backend("device", "cpu")
    assert fn.func is tp.pairing_check_device
    assert fn.keywords == {"device": CPU}
    assert fn([(None, G2_GEN)]) is True
    assert pairing_backend("host") is hp.pairing_check
    params = ParamsKZG(8, 256, G1_GEN, G2_GEN, G2_GEN)
    for strategy in (SingleStrategy(params, pairing="device", device="cpu"),
                     AccumulatorStrategy(params, pairing="device",
                                         device="cpu")):
        assert strategy._pairing.keywords == {"device": CPU}
    assert AccumulatorStrategy(params)._pairing is hp.pairing_check
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pairing_backend("device")
    with pytest.raises(RuntimeError):
        tp.pairing_check_device([(None, G2_GEN)])
    with pytest.raises(ValueError):
        pairing_backend("tpu")
