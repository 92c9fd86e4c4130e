"""The verifier's axes through the port on the CPU, each verdict equal to
the JAX package's on the same proofs: the accumulator and single
strategies (tests/test_batch_strategy.py), the error surface
(tests/test_error_surface.py), forged proofs (tests/test_forged_proofs.py)
and the lookup and shuffle arguments (tests/test_e2e_lookup_shuffle.py),
with the port's BatchVerifier on device="cpu". Where the verdict is what
is tested the proofs come from the committed pack params/test_vm_k8_pack
.npz; forged, lookup and shuffle proofs are made by the port's prover,
whose bytes equal the JAX prover's (tests/test_torch_prover.py)."""

import pytest
import torch

from halo2_verifier_tpu.config import VerifierConfig as JaxVerifierConfig
from halo2_verifier_tpu.parallel.orchestrator import (
    BatchVerifier as JaxBatchVerifier,
)
from halo2_verifier_tpu.prover import circuits as jcircuits
from halo2_verifier_tpu.prover import keygen as jkeygen
from halo2_verifier_tpu.prover import srs as jsrs
from halo2_verifier_tpu.protocol import kzg as jkzg
from halo2_verifier_tpu.protocol import verifier as jverifier
from halo2_verifier_tpu.protocol import vk as jvk
from halo2_verifier_tpu import transcript as jtranscript
from halo2_verifier_tpu_torch import VerifierConfig
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier
from halo2_verifier_tpu_torch.protocol.columns import ADVICE, Column
from halo2_verifier_tpu_torch.protocol.kzg import (
    AccumulatorStrategy,
    BoundsFailure,
    InstanceTooLarge,
)
from halo2_verifier_tpu_torch.protocol.verifier import (
    verify_proof,
    verify_proof_single,
)
from halo2_verifier_tpu_torch.protocol.vk import VerifyingKey
from halo2_verifier_tpu_torch.prover.circuits import (
    lookup_spec,
    shuffle_spec,
    vector_mul_spec,
)
from halo2_verifier_tpu_torch.prover.fixtures import vm_k8_batch
from halo2_verifier_tpu_torch.prover.keygen import keygen
from halo2_verifier_tpu_torch.prover.prove import create_proof
from halo2_verifier_tpu_torch.prover.srs import load_srs
from halo2_verifier_tpu_torch.transcript import (
    TRANSCRIPT_READERS,
    TRANSCRIPT_WRITERS,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_host_msm(monkeypatch):
    """The JAX BatchVerifier on its exact host MSM (no XLA compiles)."""
    monkeypatch.setenv("H2V_MSM", "host")


@pytest.fixture(scope="module")
def vm8():
    """(port params, port vk, JAX params, JAX vk, [(proof, instances)])
    of the committed vector_mul k=8 pack, the key derived by each
    package's keygen."""
    params, vk, items = vm_k8_batch()
    jsrs8 = jsrs.load_srs(8)
    jspec, _mk = jcircuits.vector_mul_spec(8, 3)
    jpk = jkeygen.keygen(jspec, jsrs8)
    assert jpk.vk.to_bytes() == vk.to_bytes()
    return params, vk, jsrs8.verifier_params(), jpk.vk, items


def _tampered(items, index=1):
    """items with one proof byte flipped at `index` (past its first
    commitment's encoding, so the proof stays parseable)."""
    bad = bytearray(items[index][0])
    bad[100] ^= 0xFF
    out = list(items)
    out[index] = (bytes(bad), items[index][1])
    return out


def _bumped(items, index=1):
    """items with the first public input of `index` + 1."""
    p, inst = items[index]
    out = list(items)
    out[index] = (p, [[inst[0][0] + 1] + list(inst[0][1:])])
    return out


def _lcg():
    state = [42]

    def rng():
        state[0] = (state[0] * 6364136223846793005
                    + 1442695040888963407) % (2**64)
        return state[0]

    return rng


# --------------------------------------- tests/test_batch_strategy.py

def _accumulate(verify, strategy, vk, params, items, reader):
    for proof, instance in items:
        strategy = verify(params, vk, strategy, [instance], reader(proof))
    return strategy.finalize()


def test_batch_accumulator_single_pairing(vm8):
    params, vk, jparams, jvk_, items = vm8
    ours = _accumulate(verify_proof, AccumulatorStrategy(params, rng=_lcg()),
                       vk, params, items, TRANSCRIPT_READERS["blake2b"])
    ref = _accumulate(jverifier.verify_proof,
                      jkzg.AccumulatorStrategy(jparams, rng=_lcg()), jvk_,
                      jparams, items, jtranscript.TRANSCRIPT_READERS["blake2b"])
    assert ours is True and ref is True


def test_batch_detects_bad_proof_and_localizes(vm8):
    params, vk, jparams, jvk_, items = vm8
    bad = _tampered(items)
    try:
        batch_ok = _accumulate(verify_proof, AccumulatorStrategy(params), vk,
                               params, bad, TRANSCRIPT_READERS["blake2b"])
    except Exception:
        batch_ok = False  # tampering may corrupt a point encoding
    assert not batch_ok
    verdicts = [verify_proof_single(params, vk, p, [inst])
                for p, inst in bad]
    want = [jverifier.verify_proof_single(jparams, jvk_, p, [inst])
            for p, inst in bad]
    assert verdicts == want == [True, False, True]


def test_strategy_single_localizes_like_jax(vm8, jax_host_msm):
    params, vk, jparams, jvk_, items = vm8
    bad = _tampered(items)
    res = BatchVerifier(params, vk, device="cpu",
                        strategy="single").verify(bad)
    want = JaxBatchVerifier(jparams, jvk_, strategy="single").verify(bad)
    assert (res.ok, res.failed_indices) == (want.ok, want.failed_indices)
    assert res.failed_indices == [1]


# --------------------------------------- tests/test_error_surface.py

def test_instance_too_large_raised(vm8):
    params, vk, jparams, jvk_, items = vm8
    proof = items[0][0]
    usable = params.n - (vk.cs.blinding_factors() + 1)
    oversized = [[1] * (usable + 1)]

    class _Strategy:
        def process(self, f):
            raise AssertionError("must fail before strategy runs")

    with pytest.raises(InstanceTooLarge):
        verify_proof(params, vk, _Strategy(), [oversized],
                     TRANSCRIPT_READERS["blake2b"](proof))
    with pytest.raises(jkzg.InstanceTooLarge):
        jverifier.verify_proof(jparams, jvk_, _Strategy(), [oversized],
                               jtranscript.TRANSCRIPT_READERS["blake2b"](proof))


def _corrupt_query(vk_bytes):
    tampered = VerifyingKey.from_bytes(vk_bytes)
    col, rot = tampered.cs.advice_queries[0]
    tampered.cs.advice_queries[0] = (
        Column(ADVICE, tampered.cs.num_advice_columns + 7, col.phase), rot)
    return tampered.to_bytes()


def _corrupt_gate(vk_bytes):
    tampered = VerifyingKey.from_bytes(vk_bytes)
    cs = tampered.cs
    num_vars = (len(cs.advice_queries) + len(cs.fixed_queries)
                + len(cs.instance_queries) + cs.num_challenges)
    coeff_idx, _term = cs.gates[0].terms[0]
    cs.gates[0].terms[0] = (coeff_idx, ((num_vars + 3, 1),))
    return tampered.to_bytes()


@pytest.mark.parametrize("corrupt", [_corrupt_query, _corrupt_gate],
                         ids=["query_index", "gate_variable"])
def test_bounds_failure_on_corrupt_vk(vm8, corrupt):
    _params, vk, _jparams, _jvk, _items = vm8
    bad = corrupt(vk.to_bytes())
    with pytest.raises(BoundsFailure):
        VerifyingKey.from_bytes(bad)
    with pytest.raises(jkzg.BoundsFailure):
        jvk.VerifyingKey.from_bytes(bad)


def test_good_vk_roundtrips_clean(vm8):
    _params, vk, _jparams, jvk_, _items = vm8
    assert VerifyingKey.from_bytes(vk.to_bytes()).to_bytes() == vk.to_bytes()
    assert vk.to_bytes() == jvk_.to_bytes()


def test_config_strategy_single_is_live(vm8, jax_host_msm):
    params, vk, jparams, jvk_, items = vm8
    good = items[0]
    batch = [good, _bumped(items)[1], good]
    bv = VerifierConfig(strategy="single").make_verifier(params, vk,
                                                         device="cpu")
    assert bv.strategy == "single"
    res = bv.verify(batch)
    want = JaxVerifierConfig(strategy="single").make_verifier(
        jparams, jvk_).verify(batch)
    assert (res.ok, res.failed_indices) == (want.ok, want.failed_indices)
    assert res.failed_indices == [1]
    results = list(bv.verify_stream(iter([[good], [batch[1]]])))
    assert results[0].ok and not results[1].ok


def test_config_strategy_accumulator_default(vm8, jax_host_msm):
    """The default configuration: the accumulator, the forest MSM."""
    params, vk, jparams, jvk_, items = vm8
    bv = VerifierConfig().make_verifier(params, vk, device="cpu")
    assert bv.strategy == "accumulator" and bv.msm == "forest"
    res = bv.verify(items[:1])
    want = JaxVerifierConfig().make_verifier(jparams, jvk_).verify(items[:1])
    assert res.ok and want.ok


def test_unknown_strategy_rejected(vm8):
    params, vk, *_ = vm8
    with pytest.raises(ValueError):
        VerifierConfig(strategy="bogus").make_verifier(params, vk,
                                                       device="cpu")


# --------------------------------------- tests/test_forged_proofs.py

@pytest.fixture(scope="module")
def srs8():
    return load_srs(8)


def _prove(pk, asg, hash_name="blake2b", **kw):
    return create_proof(pk, [asg], TRANSCRIPT_WRITERS[hash_name](), **kw)


def _jax_verdict(pk_spec_args, spec_fn, proof, instances, **kw):
    """The JAX verifier's verdict on `proof`, with the key its own keygen
    derives for the same circuit."""
    jspec = spec_fn(*pk_spec_args)[0]
    jsrs8 = jsrs.load_srs(8)
    jpk = jkeygen.keygen(jspec, jsrs8)
    return jverifier.verify_proof_single(jsrs8.verifier_params(), jpk.vk,
                                         proof, instances, **kw)


def test_forged_lookup_rejected_by_verifier(srs8):
    spec, make_assignment, _ = lookup_spec(8, [1, 3, 5, 7], 8)
    pk = keygen(spec, srs8)
    params = srs8.verifier_params()
    proof = _prove(pk, make_assignment([1, 3, 4, 7, 1, 1, 1, 1]),
                   unchecked=True)
    assert len(proof) > 0
    assert not verify_proof_single(params, pk.vk, proof, [[]])
    assert not _jax_verdict((8, [1, 3, 5, 7], 8), jcircuits.lookup_spec,
                            proof, [[]])
    good = _prove(pk, make_assignment([1, 3, 5, 7, 1, 1, 1, 1]))
    assert verify_proof_single(params, pk.vk, good, [[]])


def test_forged_shuffle_rejected_by_verifier(srs8):
    W, H = 2, 8
    spec, make_assignment = shuffle_spec(8, W, H)
    pk = keygen(spec, srs8)
    params = srs8.verifier_params()
    cols = [[i + 1 for i in range(H)] for _ in range(W)]
    proof = _prove(pk, make_assignment(cols, [0] * H), unchecked=True)
    assert not verify_proof_single(params, pk.vk, proof, [[]])
    assert not _jax_verdict((8, W, H), jcircuits.shuffle_spec, proof, [[]])
    good_perm = list(range(H))[3:] + list(range(H))[:3]
    assert verify_proof_single(
        params, pk.vk, _prove(pk, make_assignment(cols, good_perm)), [[]])


def _vector_mul_forged_copy(srs8):
    """A vector_mul witness whose copy constraint is broken while every
    gate still holds (region A's a[0] changed alone)."""
    spec, make_assignment = vector_mul_spec(8, 4)
    pk = keygen(spec, srs8)
    a_vals, b_vals = [2, 3, 4, 5], [7, 8, 9, 10]
    asg = make_assignment(a_vals, b_vals)
    asg.advice[0][0] = 999
    return pk, asg, make_assignment(a_vals, b_vals)


def test_forged_copy_constraint_rejected_by_verifier(srs8):
    pk, bad_asg, good_asg = _vector_mul_forged_copy(srs8)
    params = srs8.verifier_params()
    proof = _prove(pk, bad_asg, unchecked=True)
    assert not verify_proof_single(params, pk.vk, proof, [bad_asg.instance])
    assert not _jax_verdict((8, 4), jcircuits.vector_mul_spec, proof,
                            [bad_asg.instance])
    assert verify_proof_single(params, pk.vk, _prove(pk, good_asg),
                               [good_asg.instance])


def test_batch_localization_fingers_forged_proof(srs8, jax_host_msm):
    pk, bad_asg, good_asg = _vector_mul_forged_copy(srs8)
    params = srs8.verifier_params()
    items = [(_prove(pk, good_asg, seed=b"0"), good_asg.instance),
             (_prove(pk, bad_asg, unchecked=True), bad_asg.instance),
             (_prove(pk, good_asg, seed=b"1"), good_asg.instance)]
    res = BatchVerifier(params, pk.vk, device="cpu", msm="host").verify(items)
    jsrs8 = jsrs.load_srs(8)
    jpk = jkeygen.keygen(jcircuits.vector_mul_spec(8, 4)[0], jsrs8)
    want = JaxBatchVerifier(jsrs8.verifier_params(), jpk.vk).verify(items)
    assert (res.ok, res.failed_indices) == (want.ok, want.failed_indices)
    assert res.failed_indices == [1]


# --------------------------------------- tests/test_e2e_lookup_shuffle.py

def test_lookup_verifies(srs8):
    table = [1, 3, 5, 7, 9, 11, 13, 15]
    spec, make_assignment, _a = lookup_spec(8, table, lookups_rows=16)
    pk = keygen(spec, srs8)
    proof = _prove(pk, make_assignment([table[i % 8] for i in range(16)]))
    assert verify_proof_single(srs8.verifier_params(), pk.vk, proof, [[]])
    assert _jax_verdict((8, table, 16), jcircuits.lookup_spec, proof, [[]])


def test_lookup_bad_witness_rejected(srs8):
    spec, make_assignment, _a = lookup_spec(8, [1, 3, 5, 7], lookups_rows=8)
    pk = keygen(spec, srs8)
    with pytest.raises(AssertionError):
        _prove(pk, make_assignment([1, 3, 4, 7, 1, 1, 1, 1]))


def test_shuffle_two_phases_verifies(srs8):
    W, H = 4, 32
    spec, make_assignment = shuffle_spec(8, W, H)
    pk = keygen(spec, srs8)
    cols = [[(c * 1000 + i * 7 + 1) for i in range(H)] for c in range(W)]
    perm = list(range(H))
    proof = _prove(pk, make_assignment(cols, perm[5:] + perm[:5]))
    assert verify_proof_single(srs8.verifier_params(), pk.vk, proof, [[]])
    assert _jax_verdict((8, W, H), jcircuits.shuffle_spec, proof, [[]])
    assert pk.vk.cs.num_challenges == 1
    assert max(pk.vk.cs.advice_column_phase) == 1


def test_shuffle_not_a_permutation_rejected(srs8):
    spec, make_assignment = shuffle_spec(8, 2, 8)
    pk = keygen(spec, srs8)
    with pytest.raises(AssertionError):
        _prove(pk, make_assignment([[i + 1 for i in range(8)]] * 2, [0] * 8))


def test_lookup_and_shuffle_keccak_gwc_batch(srs8, jax_host_msm):
    """Lookup and shuffle proofs under keccak256 x GWC, mixed in one batch
    of the port's BatchVerifier (vk=None, each item its own key), one with
    a proof byte flipped: localised as the JAX BatchVerifier localises
    it."""
    lk_spec, lk_mk, _ = lookup_spec(8, [1, 3, 5, 7], 8)
    sh_spec, sh_mk = shuffle_spec(8, 2, 8)
    lk_pk, sh_pk = keygen(lk_spec, srs8), keygen(sh_spec, srs8)
    cols = [[i + 1 for i in range(8)]] * 2
    perm = list(range(8))
    kw = {"hash_name": "keccak256", "multiopen": "gwc"}
    proofs = [
        _prove(lk_pk, lk_mk([1, 3, 5, 7, 1, 5, 7, 1]), seed=b"a", **kw),
        _prove(sh_pk, sh_mk(cols, perm[3:] + perm[:3]), seed=b"b", **kw),
        _prove(lk_pk, lk_mk([7, 5, 3, 1, 1, 5, 7, 1]), seed=b"c", **kw),
        _prove(sh_pk, sh_mk(cols, perm[1:] + perm[:1]), seed=b"d", **kw),
    ]
    bad = bytearray(proofs[3])
    bad[100] ^= 0xFF
    proofs[3] = bytes(bad)
    jsrs8 = jsrs.load_srs(8)
    jvks = [jkeygen.keygen(f(*a)[0], jsrs8).vk for f, a in (
        (jcircuits.lookup_spec, (8, [1, 3, 5, 7], 8)),
        (jcircuits.shuffle_spec, (8, 2, 8)))]
    ours = [(p, [], (lk_pk, sh_pk)[i % 2].vk) for i, p in enumerate(proofs)]
    ref = [(p, [], jvks[i % 2]) for i, p in enumerate(proofs)]
    res = BatchVerifier(srs8.verifier_params(), None, device="cpu",
                        msm="host", multiopen="gwc",
                        hash_name="keccak256").verify(ours)
    want = JaxBatchVerifier(jsrs8.verifier_params(), None, multiopen="gwc",
                            hash_name="keccak256").verify(ref)
    assert (res.ok, res.failed_indices) == (want.ok, want.failed_indices)
    assert res.failed_indices == [3]
