"""PyTorch port, orchestrator (halo2_verifier_tpu_torch/parallel/
orchestrator.py) on the CPU, mirroring tests/test_orchestrator_advanced.py:
verdicts and localized indices equal the JAX BatchVerifier's, one batch's
window-totals array is bit-equal to the JAX orchestrator's under injected
weights and a pinned pad, heterogeneous-vk batches, the sqrt pre-pass in
the stream, the scan MSM path in both limb backends, and the device
policy (no silent CPU fallback)."""

import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops.constants import R
from halo2_verifier_tpu_torch import weights
from halo2_verifier_tpu_torch.parallel.mesh import make_mesh
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier


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
def two_circuits():
    """The circuits of tests/test_orchestrator_advanced.py, proved by the
    JAX package's test prover: (jax params, port params, vm proofs, lookup
    proofs); each proof item carries (proof, instances, jax vk, port vk)."""
    from halo2_verifier_tpu.prover.circuits import lookup_spec, vector_mul_spec
    from halo2_verifier_tpu.prover.keygen import keygen
    from halo2_verifier_tpu.prover.prove import create_proof
    from halo2_verifier_tpu.prover.srs import load_srs
    from halo2_verifier_tpu.transcript import Blake2bWrite

    srs = load_srs(8)
    vm_spec, vm_mk = vector_mul_spec(8, 3)
    vm_pk = keygen(vm_spec, srs)
    lk_spec, lk_mk, _ = lookup_spec(8, [1, 3, 5, 7], 8)
    lk_pk = keygen(lk_spec, srs)
    vm_vk = weights.vk_from_reference(vm_pk.vk.to_bytes())
    lk_vk = weights.vk_from_reference(lk_pk.vk.to_bytes())

    vm_proofs = []
    for i in range(2):
        a = vm_mk([i + 2] * 3, [i + 5] * 3)
        vm_proofs.append(
            (create_proof(vm_pk, [a], Blake2bWrite(), seed=bytes([i])),
             a.instance, vm_pk.vk, vm_vk))
    lk_proofs = []
    for i in range(2):
        a = lk_mk([1, 3, 5, 7, [1, 3][i], 5, 7, 1])
        lk_proofs.append(
            (create_proof(lk_pk, [a], Blake2bWrite(), seed=bytes([16 + i])),
             a.instance, lk_pk.vk, lk_vk))
    params = srs.verifier_params()
    return (params, weights.params_from_reference(params.to_bytes()),
            vm_proofs, lk_proofs)


def _jax_items(items):
    return [(p, inst, jvk) for p, inst, jvk, _ in items]


def _port_items(items):
    return [(p, inst, tvk) for p, inst, _, tvk in items]


@pytest.fixture
def jax_host_msm(monkeypatch):
    """The JAX orchestrator on its exact host MSM (no XLA compiles): its
    verdicts are the reference for the port's."""
    monkeypatch.setenv("H2V_MSM", "host")


def test_heterogeneous_vk_batch(two_circuits, jax_host_msm):
    from halo2_verifier_tpu.parallel.orchestrator import (
        BatchVerifier as JaxBatchVerifier,
    )

    jparams, params, vm_proofs, lk_proofs = two_circuits
    items = [vm_proofs[0], lk_proofs[0], vm_proofs[1], lk_proofs[1]]
    want = JaxBatchVerifier(jparams, vk=None).verify(_jax_items(items),
                                                     localize=False)
    bv = BatchVerifier(params, vk=None, device="cpu")
    res = bv.verify(_port_items(items), localize=False)
    assert res.ok and res.num_proofs == 4
    assert (res.ok, res.failed_indices) == (want.ok, want.failed_indices)
    assert bv.point_adds_dispatched > 0


def test_heterogeneous_localizes_bad_proof(two_circuits, jax_host_msm):
    from halo2_verifier_tpu.parallel.orchestrator import (
        BatchVerifier as JaxBatchVerifier,
    )

    jparams, params, vm_proofs, lk_proofs = two_circuits
    bad_instance = [[(v + 1) % R for v in vm_proofs[1][1][0]]]
    items = [
        vm_proofs[0],
        lk_proofs[0],
        (vm_proofs[1][0], bad_instance) + vm_proofs[1][2:],
        lk_proofs[1],
    ]
    want = JaxBatchVerifier(jparams, vk=None).verify(_jax_items(items))
    res = BatchVerifier(params, vk=None, device="cpu",
                        msm="host").verify(_port_items(items))
    assert not res.ok and res.failed_indices == [2]
    assert (res.ok, res.failed_indices) == (want.ok, want.failed_indices)


def test_verify_stream_pipelined(two_circuits):
    """Streamed batches through the VM fast path and the forest MSM;
    results arrive in order (the sqrt pre-pass is covered below)."""
    _jparams, params, vm_proofs, lk_proofs = two_circuits
    batches = [
        _port_items([vm_proofs[0], lk_proofs[0]]),
        _port_items([vm_proofs[1], lk_proofs[1]]),
        _port_items([vm_proofs[0], lk_proofs[1]]),
    ]
    bv = BatchVerifier(params, vk=None, device="cpu")
    results = list(bv.verify_stream(batches, pad_to=128))
    assert [r.ok for r in results] == [True, True, True]
    assert bv.timings.counts.get("device_msm_dispatch", 0) == 3
    assert "host_assemble" in bv.timings.totals


def test_window_totals_equal_jax_orchestrator(two_circuits, monkeypatch):
    """Injected weights, pinned pad: one stream batch's (3, 16, 64)
    window-totals array is bit-equal to the JAX orchestrator's, and the
    same weights give the same accumulators while other weights move
    them."""
    from halo2_verifier_tpu.parallel.orchestrator import (
        BatchVerifier as JaxBatchVerifier,
    )

    jparams, params, vm_proofs, lk_proofs = two_circuits
    items = [vm_proofs[0], lk_proofs[0]]
    monkeypatch.delenv("H2V_MSM", raising=False)  # the JAX forest path
    jbv = JaxBatchVerifier(jparams, vk=None, rng=iter([7, 11]).__next__)
    (kind, jarr), _ = jbv._fast_stream_dispatch(_jax_items(items), (128, 128))
    assert kind == "grouped"
    want = np.asarray(jarr)

    def port_totals(w):
        bv = BatchVerifier(params, vk=None, device="cpu",
                           rng=iter(w).__next__)
        handle, pads = bv._fast_stream_dispatch(_port_items(items),
                                                (128, 128))
        assert pads == (128, 128) and handle[0] == "grouped"
        return bv, handle, BatchVerifier._fetch(handle[1])

    bv, handle, got = port_totals([7, 11])
    np.testing.assert_array_equal(got, want.astype(np.int32))
    a = bv._collect_pair(handle)
    assert bv._pairing_ok(*a)
    np.testing.assert_array_equal(port_totals([7, 11])[2], got)
    assert not np.array_equal(port_totals([8, 11])[2], got)


def test_verify_stream_device_decomp(two_circuits):
    """The sqrt pre-pass feeds the VM external roots; a tampered proof in
    the second batch is localized."""
    _jparams, params, vm_proofs, _ = two_circuits
    vk = vm_proofs[0][3]
    good = [(p, inst) for p, inst, _, _ in vm_proofs]
    bad_instance = [[(v + 1) % R for v in vm_proofs[1][1][0]]]
    batches = [good, [good[0], (vm_proofs[1][0], bad_instance)]]
    bv = BatchVerifier(params, vk, device="cpu", msm="host", decomp=True)
    results = list(bv.verify_stream(batches, pad_to=128))
    assert results[0].ok
    assert not results[1].ok and results[1].failed_indices == [1]
    assert bv.decomp_points_dispatched > 0


def test_verify_stream_device_decomp_malformed_point(two_circuits):
    """A proof whose point bytes encode x >= q fails, identified, on the
    pre-pass path."""
    from halo2_verifier_tpu_torch.protocol.replay_native import CompiledReplay

    _jparams, params, vm_proofs, _ = two_circuits
    vk = vm_proofs[0][3]
    shape = tuple(len(c) for c in vm_proofs[0][1])
    program = CompiledReplay(params, vk, shape)
    bad = bytearray(vm_proofs[0][0])
    off = program.program.point_offsets[0]
    bad[off:off + 32] = b"\xff" * 32  # x >= q, sign bit set
    batches = [[(vm_proofs[1][0], vm_proofs[1][1]),
                (bytes(bad), vm_proofs[0][1])]]
    bv = BatchVerifier(params, vk, device="cpu", msm="host", decomp=True)
    results = list(bv.verify_stream(batches, pad_to=128))
    assert not results[0].ok and results[0].failed_indices == [1]


def test_k14_fixture_verifies_and_localizes():
    """The main path's workload on the CPU (host MSM): two pack proofs
    verify; a public input changed by +1 is localized."""
    params, vk, items = weights.load_k14_mac_fixture()
    batch = items[:3]
    bad = [[(batch[1][1][0][0] + 1) % R] + batch[1][1][0][1:]]
    bv = BatchVerifier(params, vk, device="cpu", msm="host")
    assert bv.verify(batch).ok
    res = bv.verify([batch[0], (batch[1][0], bad), batch[2]])
    assert not res.ok and res.failed_indices == [1]


def _scan_case(two_circuits):
    """(vk, valid stream batch, one-proof tampered batch)."""
    _jparams, _params, vm_proofs, _ = two_circuits
    good = [(p, inst) for p, inst, _, _ in vm_proofs]
    bad_instance = [[(v + 1) % R for v in vm_proofs[1][1][0]]]
    return vm_proofs[0][3], good, [(vm_proofs[1][0], bad_instance)]


@pytest.fixture(scope="module")
def forest_verdicts(two_circuits):
    """The verdicts of msm="forest" on the scan tests' batches, and its
    count of dispatched MSM entries."""
    vk, good, bad = _scan_case(two_circuits)
    bv = BatchVerifier(two_circuits[1], vk, device="cpu")
    res = [next(iter(bv.verify_stream([good], pad_to=128))), bv.verify(bad)]
    return res, bv.msm_entries_dispatched


@pytest.mark.parametrize("backend", ["u16", "f8"])
def test_scan_msm_accepts_and_localizes(two_circuits, forest_verdicts,
                                        backend):
    """BatchVerifier(msm="scan") on the CPU (the plain versions) in each
    limb backend: the valid batch is accepted through the stream, and a
    tampered proof is localized, with the verdicts of msm="forest"."""
    params = two_circuits[1]
    vk, good, bad = _scan_case(two_circuits)
    want, forest_entries = forest_verdicts
    bv = BatchVerifier(params, vk, device="cpu", msm="scan",
                       limb_backend=backend)
    assert bv.msm == "scan" and bv.limb_backend == backend
    got = [next(iter(bv.verify_stream([good], pad_to=128))), bv.verify(bad)]
    assert [(r.ok, r.failed_indices) for r in got] == [(True, []),
                                                       (False, [0])]
    assert [(r.ok, r.failed_indices) for r in got] == [
        (r.ok, r.failed_indices) for r in want]
    assert "host_assemble" in bv.timings.totals  # the VM fast path
    assert bv.point_adds_dispatched > 0
    assert bv.msm_entries_dispatched == forest_entries


def test_unknown_msm_and_backend_names_raise(two_circuits):
    _jparams, params, vm_proofs, _ = two_circuits
    vk = vm_proofs[0][3]
    with pytest.raises(ValueError, match="msm"):
        BatchVerifier(params, vk, device="cpu", msm="tree")
    with pytest.raises(ValueError, match="limb_backend"):
        BatchVerifier(params, vk, device="cpu", msm="scan",
                      limb_backend="u32")


def test_device_policy(two_circuits, monkeypatch):
    """Entry points default to CUDA and raise when it is absent; CPU runs
    only when asked for; a mesh is a parallel.mesh.Mesh, whose device the
    verifier takes. The device pairing is bound to the verifier's device:
    CUDA by default, so it raises with the verifier when CUDA is
    absent."""
    _jparams, params, vm_proofs, _ = two_circuits
    vk = vm_proofs[0][3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        BatchVerifier(params, vk)
    with pytest.raises(RuntimeError):
        BatchVerifier(params, vk, device="cuda")
    bv = BatchVerifier(params, vk, device="cpu")
    assert bv.device.type == "cpu" and not bv.decomp
    with pytest.raises(TypeError):
        BatchVerifier(params, vk, device="cpu", mesh=object())
    mesh = make_mesh(1, device="cpu")
    bv = BatchVerifier(params, vk, mesh=mesh)
    assert bv.device == torch.device("cpu") and not bv.decomp
    with pytest.raises(RuntimeError):
        BatchVerifier(params, vk, device="cuda", mesh=mesh)
    bv = BatchVerifier(params, vk, device="cpu", pairing="device")
    assert bv._pairing_fn.keywords == {"device": torch.device("cpu")}
    with pytest.raises(RuntimeError):
        BatchVerifier(params, vk, pairing="device")


def test_host_msm_refused_on_cuda(two_circuits, monkeypatch):
    """msm='host' is for CPU orchestration tests: on a CUDA device it would
    move the main path's MSM to the host, so the constructor refuses it."""
    _jparams, params, vm_proofs, _ = two_circuits
    vk = vm_proofs[0][3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="msm='host'"):
        BatchVerifier(params, vk, device="cuda", msm="host")
    with pytest.raises(ValueError, match="msm='host'"):
        BatchVerifier(params, vk, msm="host")
    assert BatchVerifier(params, vk, device="cpu", msm="host").msm == "host"
