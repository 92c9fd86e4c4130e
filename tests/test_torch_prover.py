"""The port's test prover (halo2_verifier_tpu_torch/prover/) and L1 helpers
(ops/arith.py) against the JAX package's, on the same inputs (random ones
from a numpy seed): every comparison is exact, equal integers or equal
bytes. Also the port's read-only pack loader against the committed packs
of params/, and the instances of the k=14 fixture."""

import hashlib
import itertools
import os

import numpy as np
import pytest

from halo2_verifier_tpu import transcript as jtranscript
from halo2_verifier_tpu.ops import arith as jarith
from halo2_verifier_tpu.prover import circuits as jcircuits
from halo2_verifier_tpu.prover import fixtures as jfixtures
from halo2_verifier_tpu.prover import keygen as jkeygen
from halo2_verifier_tpu.prover import poly as jpoly
from halo2_verifier_tpu.prover import prove as jprove
from halo2_verifier_tpu.prover import srs as jsrs
from halo2_verifier_tpu.protocol.domain import EvaluationDomain as JDomain
from halo2_verifier_tpu_torch import transcript, weights
from halo2_verifier_tpu_torch.ops import arith
from halo2_verifier_tpu_torch.ops import hostcurve as hc
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, R
from halo2_verifier_tpu_torch.prover import (
    circuits,
    fixtures,
    keygen,
    poly,
    prove,
    srs,
)
from halo2_verifier_tpu_torch.protocol.domain import EvaluationDomain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "params")


def _scalars(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


@pytest.fixture(scope="module")
def srs_pair():
    """k -> (JAX FullSRS, port FullSRS), each package's load_srs."""
    return {k: (jsrs.load_srs(k), srs.load_srs(k)) for k in (8, 9)}


# ------------------------------------------------------------ ops/arith.py

def test_arith_matches_jax():
    rng = np.random.default_rng(10)
    a, b, pts_k = _scalars(rng, 9), _scalars(rng, 9), _scalars(rng, 9)
    points = [hc.g1_mul(G1_GEN, k) for k in pts_k]
    points[3] = None  # the identity takes part like any base
    assert arith.best_multiexp(a, points) == jarith.best_multiexp(a, points)
    assert arith.best_multiexp(a, points) == hc.g1_msm(a, points)
    z = _scalars(rng, 1)[0]
    assert arith.eval_polynomial(a, z) == jarith.eval_polynomial(a, z)
    assert (arith.compute_inner_product(a, b)
            == jarith.compute_inner_product(a, b))
    xs = a[:5]
    assert (arith.lagrange_interpolate(xs, b[:5])
            == jarith.lagrange_interpolate(xs, b[:5]))
    coeffs = arith.lagrange_interpolate(xs, b[:5])
    assert [arith.eval_polynomial(coeffs, x) for x in xs] == b[:5]
    assert (arith.evaluate_vanishing_polynomial(xs, z)
            == jarith.evaluate_vanishing_polynomial(xs, z))
    assert arith.evaluate_vanishing_polynomial(xs, xs[2]) == 0
    assert (list(itertools.islice(arith.powers(z), 12))
            == list(itertools.islice(jarith.powers(z), 12)))
    assert (arith.parallelize(a, lambda v: v * v % R)
            == jarith.parallelize(a, lambda v: v * v % R))
    assert arith.batch_invert(a, R) == jarith.batch_invert(a, R)


# ------------------------------------------------------------ prover/poly.py

@pytest.mark.parametrize("k", [1, 4, 6])
def test_ntt_intt_match_jax(k):
    rng = np.random.default_rng(20 + k)
    n = 1 << k
    omega = EvaluationDomain(3, k).omega
    assert omega == JDomain(3, k).omega
    v = _scalars(rng, n)
    assert poly.ntt(v, omega) == jpoly.ntt(v, omega)
    assert poly.intt(v, omega) == jpoly.intt(v, omega)
    assert poly.intt(poly.ntt(v, omega), omega) == v


def test_poly_ops_match_jax():
    rng = np.random.default_rng(30)
    a, b = _scalars(rng, 17), _scalars(rng, 11)
    z = _scalars(rng, 1)[0]
    assert poly.eval_poly(a, z) == jpoly.eval_poly(a, z)
    q = poly.poly_divide_linear(a, z)
    assert q == jpoly.poly_divide_linear(a, z)
    # a(X) - a(z) = q(X) (X - z)
    assert (poly.eval_poly(a, 5) - poly.eval_poly(a, z)) % R == (
        poly.eval_poly(q, 5) * (5 - z)) % R
    assert poly.poly_add(a, b) == jpoly.poly_add(a, b)
    assert poly.poly_sub(b, a) == jpoly.poly_sub(b, a)
    assert poly.poly_scale(a, z) == jpoly.poly_scale(a, z)


def test_domain_ops_match_jax():
    rng = np.random.default_rng(40)
    ops, jops = poly.DomainOps(EvaluationDomain(3, 4)), jpoly.DomainOps(
        JDomain(3, 4))
    v = _scalars(rng, 16)
    coeffs = ops.lagrange_to_coeff(v)
    assert coeffs == jops.lagrange_to_coeff(v)
    assert ops.coeff_to_lagrange(coeffs) == v
    ext = ops.coeff_to_extended(coeffs)
    assert ext == jops.coeff_to_extended(coeffs)
    assert ops.extended_to_coeff(ext)[:16] == coeffs
    assert ops.divide_by_vanishing(ext) == jops.divide_by_vanishing(ext)


# ------------------------------------------------------------- prover/srs.py

def test_generate_srs_same_bytes():
    ours, ref = srs.generate_srs(3), jsrs.generate_srs(3)
    data = ours.to_bytes()
    assert data == ref.to_bytes()
    assert len(data) == 4 + 2 * 8 * 64 + 2 * 128
    assert srs.FullSRS.from_bytes(data).to_bytes() == data
    assert (ours.verifier_params().to_bytes()
            == ref.verifier_params().to_bytes())


def test_load_srs_matches_jax_and_skips_partial_files(srs_pair, tmp_path,
                                                      monkeypatch):
    for k, (ref, ours) in srs_pair.items():
        assert ours.to_bytes() == ref.to_bytes()
    # a cache file of the wrong size (still being written) is not read
    full = srs_pair[8][1].to_bytes()
    (tmp_path / "kzg_bn254_8.srs").write_bytes(full[:len(full) // 2])
    monkeypatch.setattr(srs, "_SRS_CACHE", {})
    assert srs.load_srs(8, cache_dir=str(tmp_path)).to_bytes() == full
    assert not [f for f in os.listdir(PARAMS)
                if f.endswith(f".{os.getpid()}.tmp.srs")]


# ---------------------------------------------------------- prover/keygen.py

def _specs(mod):
    """name -> (spec, make_assignment) of one package's circuits."""
    lk_spec, lk_mk, _ = mod.lookup_spec(8, [1, 3, 5, 7], 8)
    return {
        "vector_mul_8_3": mod.vector_mul_spec(8, 3),
        "lookup_8": (lk_spec, lk_mk),
        "shuffle_8": mod.shuffle_spec(8, 4, 32),
        "mac_range_9": mod.mac_range_spec(9, 300, 10),
    }


@pytest.fixture(scope="module")
def pks(srs_pair):
    """name -> (JAX proving key, port proving key, JAX mk, port mk)."""
    jspecs, specs = _specs(jcircuits), _specs(circuits)
    out = {}
    for name in specs:
        k = specs[name][0].k
        out[name] = (jkeygen.keygen(jspecs[name][0], srs_pair[k][0]),
                     keygen.keygen(specs[name][0], srs_pair[k][1]),
                     jspecs[name][1], specs[name][1])
    return out


@pytest.mark.parametrize("name", ["vector_mul_8_3", "lookup_8", "shuffle_8",
                                  "mac_range_9"])
def test_keygen_vk_bytes_match_jax(pks, name):
    jpk, pk, _jmk, _mk = pks[name]
    assert pk.vk.to_bytes() == jpk.vk.to_bytes()
    assert pk.vk.to_bytes("raw_bytes") == jpk.vk.to_bytes("raw_bytes")
    assert pk.sigma_values == jpk.sigma_values


# ----------------------------------------------------------- prover/prove.py

def _assignment(name, mk, i):
    if name == "vector_mul_8_3":
        return mk([i + 2] * 3, [i + 5] * 3)
    if name == "lookup_8":
        return mk([1, 3, 5, 7, [1, 3][i % 2], 5, 7, 1])
    if name == "shuffle_8":
        perm = list(range(32))
        return mk([[c * 1000 + r * 7 + i for r in range(32)]
                   for c in range(4)], perm[5 + i:] + perm[:5 + i])
    return mk(i)


@pytest.mark.parametrize("name,hash_name,multiopen", [
    ("vector_mul_8_3", "blake2b", "shplonk"),
    ("vector_mul_8_3", "keccak256", "gwc"),
    ("lookup_8", "blake2b", "shplonk"),
    ("shuffle_8", "keccak256", "gwc"),
])
def test_create_proof_bytes_match_jax(pks, name, hash_name, multiopen):
    jpk, pk, jmk, mk = pks[name]
    ref = jprove.create_proof(jpk, [_assignment(name, jmk, 1)],
                              jtranscript.TRANSCRIPT_WRITERS[hash_name](),
                              multiopen=multiopen, seed=b"7")
    ours = prove.create_proof(pk, [_assignment(name, mk, 1)],
                              transcript.TRANSCRIPT_WRITERS[hash_name](),
                              multiopen=multiopen, seed=b"7")
    assert ours == ref and len(ours) > 0


def test_create_proof_reproduces_the_keccak_gwc_pack(pks):
    """bench.py's keccak256 x GWC proofs are the port prover's bytes."""
    _jpk, pk, _jmk, mk = pks["mac_range_9"]
    pack = fixtures.load_pack("bench_mac_k9_keccak_gwc_pack", pk, mk,
                              list(range(16)), hash_name="keccak256",
                              multiopen="gwc")
    proof = prove.create_proof(pk, [mk(3)],
                               transcript.TRANSCRIPT_WRITERS["keccak256"](),
                               seed=b"3", multiopen="gwc")
    assert proof == pack[3][0]


# -------------------------------------------------------- prover/fixtures.py

def _vm_mk(mk, n):
    return lambda s: mk([int(s) + 2] * n, [int(s) + 5] * n)


@pytest.fixture(scope="module")
def pack_keys(srs_pair, pks):
    """pack name -> (port pk, mk, seeds, hash_name, multiopen), as the
    JAX package's callers (bench.py, tests/conftest.py) build them."""
    s9 = srs_pair[9][1]
    mac_pk, mac_mk = pks["mac_range_9"][1], pks["mac_range_9"][3]
    vm9_spec, vm9_mk = circuits.vector_mul_spec(9, 4)
    vm8_pk, vm8_mk = pks["vector_mul_8_3"][1], pks["vector_mul_8_3"][3]
    return {
        "bench_mac_k9_keccak_gwc_pack": (mac_pk, mac_mk, range(16),
                                         "keccak256", "gwc"),
        "bench_mac_k9_pack": (mac_pk, mac_mk, range(8), "blake2b",
                              "shplonk"),
        "bench_vm_k9_pack": (keygen.keygen(vm9_spec, s9), _vm_mk(vm9_mk, 4),
                             range(8), "blake2b", "shplonk"),
        "test_vm_k8_pack": (vm8_pk, _vm_mk(vm8_mk, 3), range(3), "blake2b",
                            "shplonk"),
    }


@pytest.mark.parametrize("name", ["bench_mac_k9_keccak_gwc_pack",
                                  "bench_mac_k9_pack", "bench_vm_k9_pack",
                                  "test_vm_k8_pack"])
def test_keygen_reproduces_pack_vk_sha256(pack_keys, name):
    pk, mk, seeds, hash_name, multiopen = pack_keys[name]
    with np.load(os.path.join(PARAMS, f"{name}.npz")) as z:
        want = str(z["vk_sha256"])
        proofs = [p.tobytes() for p in z["proofs"]]
    assert hashlib.sha256(pk.vk.to_bytes()).hexdigest() == want
    items = fixtures.load_pack(name, pk, mk, list(seeds),
                               hash_name=hash_name, multiopen=multiopen)
    assert [p for p, _ in items] == proofs
    assert [inst for _, inst in items] == [mk(s).instance for s in seeds]


def test_vm_k8_batch_matches_jax():
    params, vk, batch = fixtures.vm_k8_batch()
    jparams, jvk, jbatch = jfixtures.vm_k8_batch()
    assert params.to_bytes() == jparams.to_bytes()
    assert vk.to_bytes() == jvk.to_bytes()
    assert batch == jbatch


@pytest.mark.parametrize("field", ["vk_sha256", "key", "seeds"])
def test_load_pack_raises_on_mismatch_and_writes_nothing(pack_keys, tmp_path,
                                                         field):
    name = "bench_mac_k9_keccak_gwc_pack"
    pk, mk, seeds, hash_name, multiopen = pack_keys[name]
    with np.load(os.path.join(PARAMS, f"{name}.npz")) as z:
        fields = {f: z[f] for f in z.files}
    fields[field] = {"vk_sha256": np.asarray("0" * 64),
                     "key": np.asarray("blake2b/shplonk"),
                     "seeds": fields["seeds"] + 1}[field]
    np.savez(tmp_path / f"{name}.npz", **fields)

    def packs():
        # the packs alone: another test process may cache an SRS meanwhile
        return {f: os.stat(os.path.join(PARAMS, f)).st_mtime_ns
                for f in os.listdir(PARAMS) if f.endswith(".npz")}

    before = packs()
    with pytest.raises(fixtures.PackMismatch, match=name):
        fixtures.load_pack(name, pk, mk, list(seeds), hash_name=hash_name,
                           multiopen=multiopen, params_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        fixtures.load_pack("no_such_pack", pk, mk, list(seeds),
                           params_dir=str(tmp_path))
    assert packs() == before
    assert sorted(os.listdir(tmp_path)) == [f"{name}.npz"]


def test_k14_fixture_instances_from_the_port_prover():
    """The public inputs stored in data/k14_mac_fixture.npz are what the
    port's mac_range circuit makes from the pack's seeds."""
    _spec, mk = circuits.mac_range_spec(14, 8192, 32)
    with np.load(weights.FIXTURE_PATH) as fx:
        seeds, inst = fx["seeds"], fx["instances"]
    for i in (0, 1, 77, len(seeds) - 1):
        assert (weights.instances_from_array(inst[i])
                == mk(int(seeds[i])).instance)
