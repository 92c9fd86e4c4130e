"""PyTorch port, the device pairing in production shape on the CPU:
tests/test_batch_strategy.py::test_device_pairing_in_production mirrored
through the port's VerifierConfig(pairing="device").make_verifier(...,
device="cpu", msm="host") on proofs of the JAX package's test prover.
Verdicts and failed indices must equal the host pairing's. A pairing
check on the CPU's plain versions takes ~25 s, so the file runs as few as
show that: the single strategy shows the exact failed index, and the
accumulator's tampered batch runs with localize=False (its localization
on the device pairing runs on the card, chip_smoke.py
tampered_batch_device_pairing)."""

import pytest
import torch

from halo2_verifier_tpu_torch import VerifierConfig, weights
from halo2_verifier_tpu_torch.ops.constants import R


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
def setup():
    """The port's params and vk for the vector_mul k=8 circuit of
    tests/test_batch_strategy.py, two valid proofs from the JAX package's
    test prover, and the second with its first public input + 1."""
    from halo2_verifier_tpu.prover.circuits import vector_mul_spec
    from halo2_verifier_tpu.prover.keygen import keygen
    from halo2_verifier_tpu.prover.prove import create_proof
    from halo2_verifier_tpu.prover.srs import load_srs
    from halo2_verifier_tpu.transcript import Blake2bWrite

    srs = load_srs(8)
    spec, make_assignment = vector_mul_spec(8, 3)
    pk = keygen(spec, srs)
    proofs = []
    for i in range(2):
        a = make_assignment([i + 2] * 3, [i + 5] * 3)
        proofs.append((create_proof(pk, [a], Blake2bWrite(),
                                    seed=bytes([i])), a.instance))
    proof, inst = proofs[1]
    bad = (proof, [[(inst[0][0] + 1) % R] + list(inst[0][1:])])
    params = weights.params_from_reference(
        srs.verifier_params().to_bytes())
    vk = weights.vk_from_reference(pk.vk.to_bytes())
    return params, vk, proofs, bad


def _verifier(setup, **config):
    params, vk, _, _ = setup
    return VerifierConfig(**config).make_verifier(params, vk, device="cpu",
                                                  msm="host")


def test_single_strategy_device_pairing(setup):
    """One device pairing per proof: the valid proof accepted, the
    tampered one rejected at its index, as with the host pairing."""
    _, _, proofs, bad = setup
    batch = [proofs[0], bad]
    bv = _verifier(setup, strategy="single", pairing="device")
    assert bv.pairing == "device" and bv.device.type == "cpu"
    r = bv.verify(batch)
    assert not r.ok and r.failed_indices == [1]
    host = _verifier(setup, strategy="single").verify(batch)
    assert (r.ok, r.failed_indices) == (host.ok, host.failed_indices)


def test_accumulator_device_pairing(setup):
    """One device pairing per batch: the valid batch accepted, the
    tampered one rejected, as with the host pairing."""
    _, _, proofs, bad = setup
    bv = _verifier(setup, pairing="device")
    assert bv.verify(proofs).ok
    tampered = [proofs[0], bad]
    r = bv.verify(tampered, localize=False)
    host = _verifier(setup).verify(tampered, localize=False)
    assert not r.ok
    assert (r.ok, r.failed_indices) == (host.ok, host.failed_indices)
    assert bv.timings.totals["device_pairing"] > 0
