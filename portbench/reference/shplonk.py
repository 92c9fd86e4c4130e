"""Frozen copy of halo2_verifier_tpu/protocol/shplonk.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

SHPLONK (BDFG20) multiopen verifier.

Reference: poly/kzg/multiopen/shplonk.rs. Queries are grouped by the full
rotation set of each commitment (first-appearance order, points in ascending
field order like the reference's BTreeSet), each set gets a low-degree
interpolant r(X), and everything collapses into a single DualMSM whose
pairing check certifies all openings.
"""

from __future__ import annotations

from .constants import R
from . import hostfield as hf
from .kzg import MSMKZG


def lagrange_interpolate(points, evals):
    """arithmetic.rs:149-202: dense coefficients of the unique interpolant."""
    assert len(points) == len(evals)
    if len(points) == 1:
        return [evals[0] % R]
    n = len(points)
    denoms = []
    for j, x_j in enumerate(points):
        row = [(x_j - x_k) % R for k, x_k in enumerate(points) if k != j]
        denoms.extend(row)
    denoms = hf.batch_invert(denoms, R)
    final_poly = [0] * n
    pos = 0
    for j, eval_j in enumerate(evals):
        tmp = [1]
        for k, x_k in enumerate(points):
            if k == j:
                continue
            denom = denoms[pos]
            pos += 1
            # multiply tmp by (X - x_k) * denom
            new = [0] * (len(tmp) + 1)
            mneg = -denom * x_k % R
            for i, c in enumerate(tmp):
                new[i] = (new[i] + c * mneg) % R
                new[i + 1] = (new[i + 1] + c * denom) % R
            tmp = new
        for i, c in enumerate(tmp):
            final_poly[i] = (final_poly[i] + c * eval_j) % R
    return final_poly


def eval_polynomial(poly, point):
    """Horner (arithmetic.rs:137-144)."""
    acc = 0
    for c in reversed(poly):
        acc = (acc * point + c) % R
    return acc


def evaluate_vanishing_polynomial(roots, z):
    """arithmetic.rs:204-206."""
    acc = 1
    for root in roots:
        acc = acc * ((z - root) % R) % R
    return acc


def construct_intermediate_sets(queries):
    """shplonk.rs:58-149.

    Returns (rotation_sets, super_point_set); each rotation set is
    (commitments, points) where commitments are (query_commitment, evals)
    pairs ordered by first appearance and points are ascending.
    """
    eval_map = {}
    commitment_order = []       # commit_key in first-appearance order
    commitment_points = {}      # commit_key -> set of points
    commitment_obj = {}
    super_point_set = set()
    for q in queries:
        super_point_set.add(q.point)
        eval_map[(q.commit_key, q.point)] = q.eval
        if q.commit_key not in commitment_points:
            commitment_order.append(q.commit_key)
            commitment_points[q.commit_key] = set()
            commitment_obj[q.commit_key] = (q.commitment, q.is_msm)
        commitment_points[q.commit_key].add(q.point)

    # group commitments sharing the same rotation set (first-appearance order)
    set_order = []              # frozenset -> position
    set_commitments = {}
    for key in commitment_order:
        fs = frozenset(commitment_points[key])
        if fs not in set_commitments:
            set_order.append(fs)
            set_commitments[fs] = []
        set_commitments[fs].append(key)

    rotation_sets = []
    for fs in set_order:
        points = sorted(fs)
        commitments = []
        for key in set_commitments[fs]:
            evals = [eval_map[(key, p)] for p in points]
            obj, is_msm = commitment_obj[key]
            commitments.append((obj, is_msm, evals))
        rotation_sets.append((commitments, points))
    return rotation_sets, sorted(super_point_set)


def verify_shplonk(params, transcript, queries, msm_accumulator):
    """shplonk.rs:175-267. Mutates and returns the DualMSM accumulator."""
    rotation_sets, super_point_set = construct_intermediate_sets(queries)

    y = transcript.squeeze_challenge()
    v = transcript.squeeze_challenge()
    h1 = transcript.read_point()
    u = transcript.squeeze_challenge()
    h2 = transcript.read_point()

    z_0 = 0
    z_0_diff_inverse = 0
    outer_msm = MSMKZG()
    r_outer_acc = 0
    power_of_v = 1
    for i, (commitments, points) in enumerate(rotation_sets):
        diffs = [p for p in super_point_set if p not in points]
        z_diff_i = evaluate_vanishing_polynomial(diffs, u)
        if i == 0:
            z_0 = evaluate_vanishing_polynomial(points, u)
            z_0_diff_inverse = pow(z_diff_i, -1, R)
            z_diff_i = 1
        else:
            z_diff_i = z_diff_i * z_0_diff_inverse % R

        inner_msm = MSMKZG()
        r_inner_acc = 0
        power_of_y = 1
        for obj, is_msm, evals in commitments:
            r_x = lagrange_interpolate(points, evals)
            r_inner_acc = (r_inner_acc + power_of_y * eval_polynomial(r_x, u)) % R
            if is_msm:
                m = obj.clone()
                m.scale(power_of_y)
                inner_msm.add_msm(m)
            else:
                inner_msm.append_term(power_of_y, obj)
            power_of_y = power_of_y * y % R

        inner_msm.scale(power_of_v * z_diff_i % R)
        outer_msm.add_msm(inner_msm)
        r_outer_acc = (r_outer_acc + power_of_v * r_inner_acc % R * z_diff_i) % R
        power_of_v = power_of_v * v % R

    outer_msm.append_term(-r_outer_acc % R, params.g)
    outer_msm.append_term(-z_0 % R, h1)
    outer_msm.append_term(u, h2)

    msm_accumulator.left.append_term(1, h2)
    msm_accumulator.right.add_msm(outer_msm)
    return msm_accumulator
