"""Keygen for the test-only prover: CircuitSpec + SRS -> VerifyingKey/ProvingKey.

Replicates what upstream `keygen_vk` + `convert_verifier_key` produce
(serialize/src/lib.rs:12-24): fixed commitments, permutation sigma
commitments, the constraint system with gates as indexed sparse polynomials
over a deduped coefficient pool, and a transcript_repr scalar.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..ops import hostcurve as hc
from ..ops.constants import FR_DELTA, R
from ..ops.hostfield import fr_from_uniform_bytes
from ..protocol.domain import EvaluationDomain
from ..protocol.vk import (
    ConstraintSystem,
    LookupArgument,
    PermutationArgument,
    PermutationVerifyingKey,
    ShuffleArgument,
    VerifyingKey,
)
from .circuit import CircuitSpec
from .srs import FullSRS


@dataclass
class ProvingKey:
    spec: CircuitSpec
    vk: VerifyingKey
    srs: FullSRS
    sigma_values: list  # per permutation column: length-n Lagrange values
    cs_degree: int


def _expr_x_degree(poly, num_challenges: int) -> int:
    """Degree in X of a compiled gate: challenge variables are scalars."""
    challenge_start = poly.num_vars - num_challenges
    deg = 0
    for _, term in poly.terms:
        d = sum(p for v, p in term if v < challenge_start)
        deg = max(deg, d)
    return deg


def compute_cs_degree(spec: CircuitSpec, compiled_gates, compiled_lookups,
                      compiled_shuffles) -> int:
    nch = len(spec.challenge_phase)
    deg = 3  # floor: permutation boundary/grand-product structure
    for g in compiled_gates:
        deg = max(deg, _expr_x_degree(g, nch))
    for inputs, tables in compiled_lookups:
        din = max((_expr_x_degree(e, nch) for e in inputs), default=1)
        dta = max((_expr_x_degree(e, nch) for e in tables), default=1)
        deg = max(deg, 2 + din + dta)
    for inputs, shuffles in compiled_shuffles:
        din = max((_expr_x_degree(e, nch) for e in inputs), default=1)
        dsh = max((_expr_x_degree(e, nch) for e in shuffles), default=1)
        deg = max(deg, 2 + max(din, dsh))
    return deg


def build_sigma(spec: CircuitSpec, usable_rows: int):
    """Permutation sigma values: start from the identity deltaomega layout
    (delta^col * omega^row) and rotate each copy-cycle."""
    n = spec.n
    domain = EvaluationDomain(3, spec.k)  # omega only; degree irrelevant here
    cols = spec.permutation_columns
    col_pos = {c: i for i, c in enumerate(cols)}

    # union-find over cells
    parent: dict = {}

    def find(cell):
        while parent.get(cell, cell) != cell:
            parent[cell] = parent.get(parent[cell], parent[cell])
            cell = parent[cell]
        return cell

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for col_a, row_a, col_b, row_b in spec.copies:
        assert row_a < usable_rows and row_b < usable_rows, (
            "copy constraints must stay within usable rows"
        )
        union((col_pos[col_a], row_a), (col_pos[col_b], row_b))

    cycles: dict = {}
    for col_a, row_a, col_b, row_b in spec.copies:
        for cell in ((col_pos[col_a], row_a), (col_pos[col_b], row_b)):
            root = find(cell)
            cycles.setdefault(root, set()).add(cell)

    # deltaomega(c, r) = delta^c * omega^r
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * domain.omega % R
    delta_pows = [pow(FR_DELTA, c, R) for c in range(len(cols))]

    sigma = [
        [delta_pows[c] * omega_pows[r] % R for r in range(n)]
        for c in range(len(cols))
    ]
    for cycle in cycles.values():
        cells = sorted(cycle)
        for (c1, r1), (c2, r2) in zip(cells, cells[1:] + cells[:1]):
            sigma[c1][r1] = delta_pows[c2] * omega_pows[r2] % R
    return sigma


def commit_lagrange(srs: FullSRS, values) -> tuple:
    return hc.g1_msm(values, srs.g_lagrange[: len(values)])


def commit_coeff(srs: FullSRS, coeffs) -> tuple:
    assert len(coeffs) <= len(srs.g)
    return hc.g1_msm(coeffs, srs.g[: len(coeffs)])


def keygen(spec: CircuitSpec, srs: FullSRS) -> ProvingKey:
    assert srs.k == spec.k
    spec.finalize_queries()

    compiled_gates = [spec.compile_expr(g) for g in spec.gates]
    compiled_lookups = [
        ([spec.compile_expr(e) for e in ins], [spec.compile_expr(e) for e in tbs])
        for ins, tbs in spec.lookups
    ]
    compiled_shuffles = [
        ([spec.compile_expr(e) for e in ins], [spec.compile_expr(e) for e in shs])
        for ins, shs in spec.shuffles
    ]
    cs_degree = compute_cs_degree(spec, compiled_gates, compiled_lookups,
                                  compiled_shuffles)

    # shared coefficient pool, populated gates -> lookups -> shuffles in the
    # exact order of convert_constraint_system (serialize/src/lib.rs:38-213)
    pool: list[int] = []
    gates = [g.index_into(pool) for g in compiled_gates]
    lookups = []
    for ins, tbs in compiled_lookups:
        lookups.append(LookupArgument(
            [e.index_into(pool) for e in ins],
            [e.index_into(pool) for e in tbs],
        ))
    shuffles = []
    for ins, shs in compiled_shuffles:
        shuffles.append(ShuffleArgument(
            [e.index_into(pool) for e in ins],
            [e.index_into(pool) for e in shs],
        ))

    num_advice_queries = [0] * len(spec.advice_phase)
    for col, _ in spec.advice_queries:
        num_advice_queries[col.index] += 1

    cs = ConstraintSystem(
        num_fixed_columns=spec.num_fixed,
        num_advice_columns=len(spec.advice_phase),
        num_instance_columns=spec.num_instance,
        num_selectors=0,
        num_challenges=len(spec.challenge_phase),
        advice_column_phase=list(spec.advice_phase),
        challenge_phase=list(spec.challenge_phase),
        gates=gates,
        num_advice_queries=num_advice_queries,
        advice_queries=list(spec.advice_queries),
        instance_queries=list(spec.instance_queries),
        fixed_queries=list(spec.fixed_queries),
        permutation=PermutationArgument(list(spec.permutation_columns)),
        lookups=lookups,
        shuffles=shuffles,
        coeff_vals=pool,
    )

    blinding_factors = cs.blinding_factors()
    usable_rows = spec.n - (blinding_factors + 1)
    sigma_values = build_sigma(spec, usable_rows)

    fixed_commitments = [commit_lagrange(srs, col) for col in spec.fixed_values]
    sigma_commitments = [commit_lagrange(srs, s) for s in sigma_values]

    domain = EvaluationDomain(cs_degree, spec.k)
    vk = VerifyingKey(
        domain=domain,
        fixed_commitments=fixed_commitments,
        permutation=PermutationVerifyingKey(sigma_commitments),
        cs=cs,
        cs_degree=cs_degree,
        transcript_repr=0,
        selectors=[],
    )
    # transcript fingerprint: hash of the serialized vk (upstream hashes its
    # pinned debug representation, vk.rs:145-152 consumes only the scalar)
    digest = hashlib.blake2b(vk.to_bytes("processed")).digest()
    vk.transcript_repr = fr_from_uniform_bytes(digest)
    return ProvingKey(spec, vk, srs, sigma_values, cs_degree)
