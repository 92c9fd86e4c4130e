"""Frozen copy of halo2_verifier_tpu/protocol/verifier.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

The PLONK verifier entry point.

Mirrors the reference's `verify_proof` (lib.rs:33-425) phase by phase:
transcript replay -> challenge derivation -> instance barycentric evals ->
h(x) expression folding -> opening-query assembly -> multiopen -> strategy.

The host replay is deliberately split from the arithmetic so the batched
device path can reuse the exact same structure: all challenges/evals for a
batch of proofs are extracted here, then the scalar math and MSMs execute as
vectorized device programs (see parallel/orchestrator.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from .constants import R
from .transcript import TRANSCRIPT_READERS
from .arguments import (
    LookupVerifier,
    PermutationCommitted,
    PermutationCommonEvaluated,
    ShuffleVerifier,
    VanishingVerifier,
)
from .gwc import verify_gwc
from .kzg import DualMSM, InstanceTooLarge, SingleStrategy, VerifyFailure
from .queries import VerifierQuery
from .shplonk import verify_shplonk

MULTIOPEN_VERIFIERS = {"shplonk": verify_shplonk, "gwc": verify_gwc}


class InvalidInstances(VerifyFailure):
    pass


def verify_proof(params, vk, strategy, instances, transcript,
                 multiopen="shplonk"):
    """Verify one or more proofs sharing a transcript (lib.rs:33-425).

    instances: [proof][column][row] list of Fr ints.
    Raises VerifyFailure (or returns the strategy's output) exactly where the
    reference returns Err/Ok.
    """
    for instance in instances:
        if len(instance) != vk.cs.num_instance_columns:
            raise InvalidInstances("instance column count mismatch")

    # Error::InstanceTooLarge (plonk/mod.rs:30-31): instance rows must fit
    # in the usable region n - (blinding_factors + 1) — rows past it are
    # reserved for blinding and the permutation's last-row constraints.
    usable_rows = params.n - (vk.cs.blinding_factors() + 1)
    for instance in instances:
        for column in instance:
            if len(column) > usable_rows:
                raise InstanceTooLarge(
                    f"instance column of {len(column)} rows exceeds the "
                    f"{usable_rows} usable rows of a 2^{params.k} circuit"
                )

    num_proofs = len(instances)
    verify_mo = MULTIOPEN_VERIFIERS[multiopen]

    # vk fingerprint + instance values into the transcript (lib.rs:66-83)
    vk.hash_into(transcript)
    for instance in instances:
        for column in instance:
            for value in column:
                transcript.common_scalar(value)

    # phased advice commitments + in-circuit challenges (lib.rs:86-112)
    advice_commitments = [
        [None] * vk.cs.num_advice_columns for _ in range(num_proofs)
    ]
    challenges = [0] * vk.cs.num_challenges
    for current_phase in vk.cs.phases():
        for commitments in advice_commitments:
            for i, phase in enumerate(vk.cs.advice_column_phase):
                if current_phase == phase:
                    commitments[i] = transcript.read_point()
        for i, phase in enumerate(vk.cs.challenge_phase):
            if current_phase == phase:
                challenges[i] = transcript.squeeze_challenge()

    theta = transcript.squeeze_challenge()  # lib.rs:115

    lookups_permuted = [
        [LookupVerifier.read_permuted_commitments(transcript)
         for _ in vk.cs.lookups]
        for _ in range(num_proofs)
    ]

    beta = transcript.squeeze_challenge()   # lib.rs:129
    gamma = transcript.squeeze_challenge()  # lib.rs:132

    permutations_committed = [
        PermutationCommitted.read(vk, transcript) for _ in range(num_proofs)
    ]
    lookups_committed = [
        [lk.read_product_commitment(transcript) for lk in lookups]
        for lookups in lookups_permuted
    ]
    shuffles_committed = [
        [ShuffleVerifier.read_product_commitment(transcript)
         for _ in vk.cs.shuffles]
        for _ in range(num_proofs)
    ]

    # ONE vanishing argument per transcript regardless of num_proofs
    # (lib.rs:163)
    vanishing = VanishingVerifier.read_commitments_before_y(transcript)

    y = transcript.squeeze_challenge()      # lib.rs:166
    vanishing.read_commitments_after_y(vk, transcript)
    x = transcript.squeeze_challenge()      # lib.rs:172

    # barycentric instance evals (lib.rs:180-218; QUERY_INSTANCE is false for
    # both KZG multiopen verifiers)
    xn = pow(x, params.n, R)
    min_rot, max_rot = 0, 0
    for _, rot in vk.cs.instance_queries:
        min_rot = min(min_rot, rot)
        max_rot = max(max_rot, rot)
    max_instance_len = max(
        (len(col) for inst in instances for col in inst), default=0
    )
    l_i_s = vk.domain.l_i_range(
        x, xn, range(-max_rot, max_instance_len + abs(min_rot))
    )
    instance_evals = []
    for instance in instances:
        evals = []
        for column, rot in vk.cs.instance_queries:
            col_vals = instance[column.index]
            offset = max_rot - rot
            evals.append(
                sum(
                    a * b % R
                    for a, b in zip(col_vals, l_i_s[offset: offset + len(col_vals)])
                ) % R
            )
        instance_evals.append(evals)

    advice_evals = [
        transcript.read_n_scalars(len(vk.cs.advice_queries))
        for _ in range(num_proofs)
    ]
    fixed_evals = transcript.read_n_scalars(len(vk.cs.fixed_queries))

    vanishing.evaluate_after_x(transcript)

    permutations_common = PermutationCommonEvaluated.read(vk, transcript)
    permutations_evaluated = [
        p.evaluate(transcript) for p in permutations_committed
    ]
    lookups_evaluated = [
        [lk.evaluate(transcript) for lk in lookups]
        for lookups in lookups_committed
    ]
    shuffles_evaluated = [
        [sh.evaluate(transcript) for sh in shuffles]
        for shuffles in shuffles_committed
    ]

    # ---- h(x) check (lib.rs:257-347) ----
    blinding_factors = vk.cs.blinding_factors()
    l_evals = vk.domain.l_i_range(x, xn, range(-(blinding_factors + 1), 1))
    assert len(l_evals) == 2 + blinding_factors
    l_last = l_evals[0]
    l_blind = sum(l_evals[1: 1 + blinding_factors]) % R
    l_0 = l_evals[1 + blinding_factors]

    expressions = []
    for p in range(num_proofs):
        a_evals, i_evals = advice_evals[p], instance_evals[p]
        for gate in vk.cs.gates:
            expressions.append(
                gate.evaluate(vk.cs.coeff_vals, a_evals, fixed_evals, i_evals,
                              challenges)
            )
        expressions.extend(
            permutations_evaluated[p].expressions(
                vk, permutations_common.permutation_evals, a_evals,
                fixed_evals, i_evals, l_0, l_last, l_blind, beta, gamma, x,
            )
        )
        for lk, argument in zip(lookups_evaluated[p], vk.cs.lookups):
            expressions.extend(
                lk.expressions(l_0, l_last, l_blind, argument, theta, beta,
                               gamma, vk.cs.coeff_vals, a_evals, fixed_evals,
                               i_evals, challenges)
            )
        for sh, argument in zip(shuffles_evaluated[p], vk.cs.shuffles):
            expressions.extend(
                sh.expressions(l_0, l_last, l_blind, argument, theta, gamma,
                               vk.cs.coeff_vals, a_evals, fixed_evals,
                               i_evals, challenges)
            )

    vanishing.verify(expressions, y, xn)

    # ---- opening queries (lib.rs:349-414) ----
    queries = []
    for p in range(num_proofs):
        for qi, (column, rot) in enumerate(vk.cs.advice_queries):
            queries.append(VerifierQuery.from_commitment(
                ("advice", p, column.index),
                advice_commitments[p][column.index],
                vk.domain.rotate_omega(x, rot),
                advice_evals[p][qi],
            ))
        queries.extend(permutations_evaluated[p].queries(vk, x, p))
        for li, lk in enumerate(lookups_evaluated[p]):
            queries.extend(lk.queries(vk, x, p, li))
        for si, sh in enumerate(shuffles_evaluated[p]):
            queries.extend(sh.queries(vk, x, p, si))
    for qi, (column, rot) in enumerate(vk.cs.fixed_queries):
        queries.append(VerifierQuery.from_commitment(
            ("fixed", column.index),
            vk.fixed_commitments[column.index],
            vk.domain.rotate_omega(x, rot),
            fixed_evals[qi],
        ))
    queries.extend(permutations_common.queries(vk, x))
    queries.extend(vanishing.queries(x, 0))

    return strategy.process(
        lambda msm: verify_mo(params, transcript, queries, msm)
    )


def verify_proof_single(params, vk, proof: bytes, instances,
                        multiopen="shplonk", hash_name="blake2b",
                        pairing="host") -> bool:
    """Convenience wrapper: SingleStrategy over raw proof bytes; returns a
    bool like the reference tests' `verify_proof(..).is_ok()`."""
    transcript = TRANSCRIPT_READERS[hash_name](proof)
    strategy = SingleStrategy(params, pairing=pairing)
    try:
        verify_proof(params, vk, strategy, instances, transcript,
                     multiopen=multiopen)
        return True
    except (VerifyFailure, ValueError, EOFError):
        return False
