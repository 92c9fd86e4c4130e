"""The port's upstream-ingestion compiler (halo2_verifier_tpu_torch/
protocol/expression.py) beside the JAX package's: every test of
tests/test_expression_convert.py runs through both packages (each with
its own prover and verifier), and the port's converted keys and flat
polynomials equal the JAX package's, byte for byte."""

import types

import pytest

import halo2_verifier_tpu.ops.constants as jconstants
import halo2_verifier_tpu.protocol.columns as jcolumns
import halo2_verifier_tpu.protocol.expression as jexpression
import halo2_verifier_tpu.protocol.verifier as jverifier
import halo2_verifier_tpu.prover.circuits as jcircuits
import halo2_verifier_tpu.prover.keygen as jkeygen
import halo2_verifier_tpu.prover.prove as jprove
import halo2_verifier_tpu.prover.srs as jsrs
import halo2_verifier_tpu.transcript as jtranscript
import halo2_verifier_tpu_torch.ops.constants as constants
import halo2_verifier_tpu_torch.protocol.columns as columns
import halo2_verifier_tpu_torch.protocol.expression as expression
import halo2_verifier_tpu_torch.protocol.verifier as verifier
import halo2_verifier_tpu_torch.prover.circuits as circuits
import halo2_verifier_tpu_torch.prover.keygen as keygen
import halo2_verifier_tpu_torch.prover.prove as prove
import halo2_verifier_tpu_torch.prover.srs as srs
import halo2_verifier_tpu_torch.transcript as transcript

PACKAGES = {
    "jax": (jconstants, jcolumns, jexpression, jverifier, jcircuits,
            jkeygen, jprove, jsrs, jtranscript),
    "torch": (constants, columns, expression, verifier, circuits, keygen,
              prove, srs, transcript),
}


def _namespace(name):
    (const, cols, expr, ver, circ, kg, pr, sr, tr) = PACKAGES[name]
    return types.SimpleNamespace(
        name=name, R=const.R, ADVICE=cols.ADVICE, INSTANCE=cols.INSTANCE,
        Column=cols.Column, x=expr,
        verify_proof_single=ver.verify_proof_single,
        vector_mul_spec=circ.vector_mul_spec,
        lookup_spec=circ.lookup_spec, keygen=kg.keygen,
        create_proof=pr.create_proof, load_srs=sr.load_srs,
        TRANSCRIPT_WRITERS=tr.TRANSCRIPT_WRITERS)


@pytest.fixture(scope="module", params=sorted(PACKAGES))
def pkg(request):
    return _namespace(request.param)


@pytest.fixture(scope="module")
def both():
    return _namespace("jax"), _namespace("torch")


def _vector_mul_upstream_cs(m):
    """The vector_mul circuit described the upstream way: recursive
    expressions over (column, rotation) queries — no pre-assigned query
    indices (tests/vector_mul.rs:94-127 configure())."""
    x = m.x
    a0, a1, a2 = x.AdviceQuery(0), x.AdviceQuery(1), x.AdviceQuery(2)
    gate = x.FixedQuery(0) * (a0 * a1 - a2)
    return x.UpstreamConstraintSystem(
        num_fixed_columns=1,
        num_advice_columns=3,
        num_instance_columns=1,
        num_selectors=0,
        num_challenges=0,
        advice_column_phase=[0, 0, 0],
        challenge_phase=[],
        gates=[[gate]],
        advice_queries=[(0, 0, 0), (1, 0, 0), (2, 0, 0)],
        fixed_queries=[(0, 0)],
        instance_queries=[(0, 0)],
        permutation_columns=[m.Column(m.ADVICE, 0), m.Column(m.ADVICE, 1),
                             m.Column(m.ADVICE, 2), m.Column(m.INSTANCE, 0)],
    )


def _upstream_vk(m, pk, ucs):
    return m.x.UpstreamVerifyingKey(
        k=8, cs_degree=pk.vk.cs_degree,
        fixed_commitments=pk.vk.fixed_commitments,
        permutation_commitments=pk.vk.permutation.commitments,
        cs=ucs, transcript_repr=pk.vk.transcript_repr)


def _lookup_upstream_cs(m):
    x = m.x
    qa = x.FixedQuery(1) * x.AdviceQuery(0)
    qt = x.FixedQuery(1) * x.FixedQuery(0)
    return x.UpstreamConstraintSystem(
        num_fixed_columns=2, num_advice_columns=1, num_instance_columns=0,
        num_challenges=0, advice_column_phase=[0], gates=[],
        advice_queries=[(0, 0, 0)], fixed_queries=[(1, 0), (0, 0)],
        instance_queries=[], permutation_columns=[], lookups=[([qa], [qt])])


def _algebra_cs(m):
    return m.x.UpstreamConstraintSystem(
        num_fixed_columns=1, num_advice_columns=1, num_instance_columns=1,
        num_challenges=1, advice_column_phase=[0], challenge_phase=[0],
        advice_queries=[(0, 0, 0)], fixed_queries=[(0, 0)],
        instance_queries=[(0, 0)])


def test_vector_mul_vk_byte_identical(pkg):
    spec, _mk = pkg.vector_mul_spec(8, 10)
    pk = pkg.keygen(spec, pkg.load_srs(8))
    vk2 = pkg.x.convert_verifier_key(
        _upstream_vk(pkg, pk, _vector_mul_upstream_cs(pkg)))
    assert vk2.to_bytes() == pk.vk.to_bytes()


def test_converted_vk_verifies_real_proof(pkg):
    srs8 = pkg.load_srs(8)
    spec, mk = pkg.vector_mul_spec(8, 10)
    pk = pkg.keygen(spec, srs8)
    asg = mk([2] * 10, [3] * 10)
    proof = pkg.create_proof(pk, [asg], pkg.TRANSCRIPT_WRITERS["blake2b"]())
    vk2 = pkg.x.convert_verifier_key(
        _upstream_vk(pkg, pk, _vector_mul_upstream_cs(pkg)))
    assert pkg.verify_proof_single(srs8.verifier_params(), vk2, proof,
                                   [asg.instance])


def test_lookup_circuit_pool_order_matches(pkg):
    spec, _mk, _a = pkg.lookup_spec(8, list(range(16)), 8)
    pk = pkg.keygen(spec, pkg.load_srs(8))
    cs2 = pkg.x.convert_constraint_system(_lookup_upstream_cs(pkg))
    assert cs2 == pk.vk.cs


def test_virtual_selector_rejected(pkg):
    x = pkg.x
    with pytest.raises(x.VirtualSelectorError):
        x.expression_transform(_vector_mul_upstream_cs(pkg),
                               x.Selector(0) * x.AdviceQuery(0))


def test_nonexistent_query_rejected(pkg):
    x = pkg.x
    ucs = _vector_mul_upstream_cs(pkg)
    with pytest.raises(KeyError):
        x.expression_transform(ucs, x.AdviceQuery(0, rotation=5))
    with pytest.raises(KeyError):
        x.expression_transform(ucs, x.FixedQuery(3))
    with pytest.raises(KeyError):
        x.expression_transform(ucs, x.InstanceQuery(0, rotation=-1))


def test_transform_algebra(pkg):
    x = pkg.x
    ucs = _algebra_cs(pkg)
    # 5*a - c*i  (a=var0, fixed=var1, instance=var2, challenge=var3)
    e = x.AdviceQuery(0) * 5 - x.Challenge(0) * x.InstanceQuery(0)
    p = x.expression_transform(ucs, e)
    assert p.num_vars == 4
    terms = {tuple(t): c for c, t in p.terms}
    assert terms[((0, 1),)] == 5
    assert terms[((2, 1), (3, 1))] == pkg.R - 1
    p2 = x.expression_transform(ucs, x.Constant(7) + x.Constant(3))
    assert p2.terms == [(10, ())]


# ------------------------------------------------- across the two packages

def test_converted_keys_equal_across_packages(both):
    jm, m = both
    out = []
    for pk_m in (jm, m):
        spec, _mk = pk_m.vector_mul_spec(8, 10)
        pk = pk_m.keygen(spec, pk_m.load_srs(8))
        out.append(pk_m.x.convert_verifier_key(
            _upstream_vk(pk_m, pk, _vector_mul_upstream_cs(pk_m))))
    assert out[1].to_bytes() == out[0].to_bytes()


def test_flat_polynomials_equal_across_packages(both):
    """The same upstream expressions fold to the same flat terms, over
    sums, products, scalings, negations and constants."""
    polys = []
    for m in both:
        x = m.x
        ucs = _algebra_cs(m)
        a, f, i, c = (x.AdviceQuery(0), x.FixedQuery(0), x.InstanceQuery(0),
                      x.Challenge(0))
        exprs = [a * 5 - c * i, (a + f) * (a - i) * 3, -(f * f) + c,
                 x.Constant(m.R - 2) * a * a + x.Constant(9)]
        polys.append([(p.num_vars, p.terms) for p in
                      (x.expression_transform(ucs, e) for e in exprs)])
    assert polys[0] == polys[1]
