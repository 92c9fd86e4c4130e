"""Frozen copy of halo2_verifier_tpu/protocol/gwc.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

GWC19 multiopen verifier (plain KZG, one witness per distinct point).

Reference: poly/kzg/multiopen/gwc.rs. Queries group by point in
first-appearance order; per-point commitments batch by powers of v, points
batch by powers of u.
"""

from __future__ import annotations

from .constants import R
from .kzg import MSMKZG


def construct_intermediate_sets(queries):
    """gwc.rs:138-163: group queries by point, first-appearance order."""
    order = []
    grouped = {}
    for q in queries:
        if q.point not in grouped:
            order.append(q.point)
            grouped[q.point] = []
        grouped[q.point].append(q)
    return [(p, grouped[p]) for p in order]


def verify_gwc(params, transcript, queries, msm_accumulator):
    """gwc.rs:54-135. Mutates and returns the DualMSM accumulator."""
    v = transcript.squeeze_challenge()
    commitment_data = construct_intermediate_sets(queries)
    w = transcript.read_n_points(len(commitment_data))
    u = transcript.squeeze_challenge()

    commitment_multi = MSMKZG()
    eval_multi = 0
    witness = MSMKZG()
    witness_with_aux = MSMKZG()

    power_of_u = 1
    for (z, point_queries), wi in zip(commitment_data, w):
        commitment_batch = MSMKZG()
        eval_batch = 0
        power_of_v = 1
        for q in point_queries:
            if q.is_msm:
                m = q.commitment.clone()
                m.scale(power_of_v)
                commitment_batch.add_msm(m)
            else:
                commitment_batch.append_term(power_of_v, q.commitment)
            eval_batch = (eval_batch + power_of_v * q.eval) % R
            power_of_v = power_of_v * v % R

        commitment_batch.scale(power_of_u)
        commitment_multi.add_msm(commitment_batch)
        eval_multi = (eval_multi + power_of_u * eval_batch) % R
        witness_with_aux.append_term(power_of_u * z % R, wi)
        witness.append_term(power_of_u, wi)
        power_of_u = power_of_u * u % R

    msm_accumulator.left.add_msm(witness)
    msm_accumulator.right.add_msm(witness_with_aux)
    msm_accumulator.right.add_msm(commitment_multi)
    from . import hostcurve as hc
    msm_accumulator.right.append_term(eval_multi, hc.g1_neg(params.g))
    return msm_accumulator
