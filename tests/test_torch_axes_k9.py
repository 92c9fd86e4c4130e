"""bench.py's two k=9 configurations through the port's BatchVerifier on
the CPU (device="cpu": the forest MSM on its plain torch versions, the
exact host MSM where a failing batch is bisected), each verdict and
localised index equal to the JAX BatchVerifier's on the same
proofs: keccak256 x GWC on the mac_range circuit (the case of
tests/test_e2e_mac_range.py:43 and its stream and localisation) and
mac_range and vector_mul proofs mixed under vk=None
(tests/test_orchestrator_advanced.py:42-54). The proofs come from the
committed packs, with the keys derived by each package's keygen."""

import pytest
import torch

from halo2_verifier_tpu.parallel.orchestrator import (
    BatchVerifier as JaxBatchVerifier,
)
from halo2_verifier_tpu.prover import circuits as jcircuits
from halo2_verifier_tpu.prover import keygen as jkeygen
from halo2_verifier_tpu.prover import srs as jsrs
from halo2_verifier_tpu.protocol import verifier as jverifier
from halo2_verifier_tpu_torch.ops.constants import R
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier
from halo2_verifier_tpu_torch.prover.circuits import (
    mac_range_spec,
    vector_mul_spec,
)
from halo2_verifier_tpu_torch.prover.fixtures import load_pack
from halo2_verifier_tpu_torch.prover.keygen import keygen
from halo2_verifier_tpu_torch.prover.srs import load_srs
from halo2_verifier_tpu_torch.protocol.verifier import verify_proof_single

GWC = {"multiopen": "gwc", "hash_name": "keccak256"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_host_msm(monkeypatch):
    monkeypatch.setenv("H2V_MSM", "host")


@pytest.fixture(scope="module")
def k9():
    """Both packages' params and keys for the k=9 mac_range (300 rows, 10
    public inputs) and vector_mul (4 products) circuits, and the packs of
    bench.py run_extras: keccak256 x GWC mac proofs, blake2b x SHPLONK mac
    and vector_mul proofs."""
    srs = load_srs(9)
    mac_spec, mac_mk = mac_range_spec(9, 300, 10)
    vm_spec, vm_mk = vector_mul_spec(9, 4)
    mac_pk, vm_pk = keygen(mac_spec, srs), keygen(vm_spec, srs)
    jsrs9 = jsrs.load_srs(9)
    jmac_vk = jkeygen.keygen(jcircuits.mac_range_spec(9, 300, 10)[0],
                             jsrs9).vk
    jvm_vk = jkeygen.keygen(jcircuits.vector_mul_spec(9, 4)[0], jsrs9).vk

    def vm_assign(s):
        return vm_mk([int(s) + 2] * 4, [int(s) + 5] * 4)

    return {
        "params": srs.verifier_params(), "jparams": jsrs9.verifier_params(),
        "mac_vk": mac_pk.vk, "vm_vk": vm_pk.vk, "jmac_vk": jmac_vk,
        "jvm_vk": jvm_vk,
        "keccak_gwc": load_pack("bench_mac_k9_keccak_gwc_pack", mac_pk,
                                mac_mk, list(range(16)), **GWC),
        "mac": load_pack("bench_mac_k9_pack", mac_pk, mac_mk,
                         list(range(8))),
        "vm": load_pack("bench_vm_k9_pack", vm_pk, vm_assign,
                        list(range(8))),
    }


def _bump(item, delta=1):
    """The item with every public input + delta (mod R)."""
    p, inst, *vk = item
    return (p, [[(v + delta) % R for v in col] for col in inst], *vk)


def test_verifies_gwc_keccak_like_jax(k9):
    params, jparams = k9["params"], k9["jparams"]
    for p, inst in k9["keccak_gwc"][:3]:
        assert verify_proof_single(params, k9["mac_vk"], p, [inst], **GWC)
        assert jverifier.verify_proof_single(jparams, k9["jmac_vk"], p,
                                             [inst], **GWC)
    p, inst = _bump(k9["keccak_gwc"][0])
    assert not verify_proof_single(params, k9["mac_vk"], p, [inst], **GWC)
    # the same proof under the other transcript or opening fails
    p, inst = k9["keccak_gwc"][0]
    assert not verify_proof_single(params, k9["mac_vk"], p, [inst],
                                   multiopen="gwc")
    assert not verify_proof_single(params, k9["mac_vk"], p, [inst],
                                   hash_name="keccak256")


def test_keccak_gwc_stream_and_localization(k9, jax_host_msm):
    """Two streamed batches through the VM fast path and the forest, then
    (on the exact host MSM: the bisection's many MSMs are orchestration)
    one proof body corrupted and one public input moved: each fails at its
    index, as in the JAX BatchVerifier."""
    batch = k9["keccak_gwc"][:4]
    bv = BatchVerifier(k9["params"], k9["mac_vk"], device="cpu", **GWC)
    results = list(bv.verify_stream(iter([batch, batch])))
    assert [(r.ok, r.num_proofs) for r in results] == [(True, 4), (True, 4)]
    assert "host_assemble" in bv.timings.totals
    bv = BatchVerifier(k9["params"], k9["mac_vk"], device="cpu", msm="host",
                       **GWC)
    p, inst = batch[2]
    corrupt = list(batch)
    corrupt[2] = (p[:64] + bytes([p[64] ^ 1]) + p[65:], inst)
    bumped = list(batch)
    bumped[1] = _bump(batch[1])
    jbv = JaxBatchVerifier(k9["jparams"], k9["jmac_vk"], **GWC)
    for bad in (corrupt, bumped):
        res = bv.verify(bad)
        want = jbv.verify(bad)
        assert not res.ok
        assert (res.ok, res.failed_indices) == (want.ok, want.failed_indices)
    assert bv.verify(corrupt).failed_indices == [2]


def _mixed(k9, jax=False):
    """mac (even index) and vector_mul (odd) proofs with their own keys,
    as bench.py's heterogeneous-vk stream builds its batches."""
    mac_vk, vm_vk = ((k9["jmac_vk"], k9["jvm_vk"]) if jax
                     else (k9["mac_vk"], k9["vm_vk"]))
    return [(*k9["mac"][i // 2], mac_vk) if i % 2 == 0
            else (*k9["vm"][i // 2], vm_vk) for i in range(4)]


def test_heterogeneous_vk_batch_like_jax(k9, jax_host_msm):
    bv = BatchVerifier(k9["params"], vk=None, device="cpu")
    (res,) = list(bv.verify_stream(iter([_mixed(k9)])))
    want = JaxBatchVerifier(k9["jparams"], vk=None).verify(_mixed(k9, True),
                                                           localize=False)
    assert res.ok and want.ok and res.num_proofs == 4
    assert bv.timings.counts.get("host_assemble") == 2  # one per vk group


def test_heterogeneous_localizes_bad_proof_like_jax(k9, jax_host_msm):
    items, jitems = _mixed(k9), _mixed(k9, True)
    items[3], jitems[3] = _bump(items[3]), _bump(jitems[3])
    res = BatchVerifier(k9["params"], vk=None, device="cpu",
                        msm="host").verify(items)
    want = JaxBatchVerifier(k9["jparams"], vk=None).verify(jitems)
    assert not res.ok and res.failed_indices == [3]
    assert (res.ok, res.failed_indices) == (want.ok, want.failed_indices)
