"""PyTorch port, the device pairing's verdicts on the CPU (halo2_verifier_
tpu_torch/ops/pairing.py pairing_check_device on the plain versions),
mirroring tests/test_pairing_jax.py::test_pairing_check_bilinearity: the
good and tampered bilinearity pairs, beside the exact host oracle's
verdicts. Two full checks (~30 s each on one core), so the file stands
alone; the final product itself is held limb for limb in
tests/test_torch_pairing_product.py."""

import pytest
import torch

from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops import hostpairing as hp
from halo2_verifier_tpu_torch.ops import pairing as tp
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, G2_GEN, R

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


def test_pairing_check_bilinearity():
    """e(aG1, bG2) * e(-abG1, G2) == 1 (the DualMSM::check shape) accepted,
    here beside an identity pair that must skip (engine semantics); a
    tampered pair rejected; the oracle agrees. The verdict compares the
    final product with Montgomery one limb for limb."""
    a, b = 6, 13
    good = [(None, _g2(3)), (_g1(a), _g2(b)),
            (hc.g1_neg(_g1(a * b)), G2_GEN)]
    bad = [(_g1(a), _g2(b)), (hc.g1_neg(_g1(a * b + 1)), G2_GEN)]
    assert tp.pairing_check_device(good, CPU) is True
    assert hp.pairing_check(good) is True
    assert tp.pairing_check_device(bad, CPU) is False
    assert hp.pairing_check(bad) is False
