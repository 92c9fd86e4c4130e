"""Example/test circuits mirroring the reference's workload coverage
(tests/vector_mul.rs, tests/shuffle.rs) plus a lookup circuit the reference
lacks coverage for (SURVEY.md §4 notes that gap).
"""

from __future__ import annotations

from ..ops.constants import R
from .circuit import Assignment, CircuitSpec


def vector_mul_spec(k: int, n_muls: int):
    """Standard PLONK: 3 advice columns, a mul gate gated by a fixed
    (selector) column, copy constraints, one instance column
    (tests/vector_mul.rs:94-127).

    Layout: region A rows [0, n): a values in adv0;
            region B rows [n, 2n): b values in adv0;
            region M rows [2n, 3n): a,b,ab in adv0,adv1,adv2 with s_mul=1;
            instance[i] constrained equal to ab cell i.
    """
    spec = CircuitSpec(k)
    adv = [spec.advice_column(), spec.advice_column(), spec.advice_column()]
    inst = spec.instance_column()
    s_mul = spec.fixed_column()
    for col in adv:
        spec.enable_equality(col)
    spec.enable_equality(inst)

    lhs = spec.query(adv[0], 0)
    rhs = spec.query(adv[1], 0)
    out = spec.query(adv[2], 0)
    sel = spec.query(s_mul, 0)
    spec.gate(sel * (lhs * rhs - out))

    base_m = 2 * n_muls
    for i in range(n_muls):
        spec.assign_fixed(s_mul, base_m + i, 1)
        # copy loaded a/b into the mul region
        spec.copy(adv[0], i, adv[0], base_m + i)
        spec.copy(adv[0], n_muls + i, adv[1], base_m + i)
        # expose the product as public input
        spec.copy(adv[2], base_m + i, inst, i)

    def make_assignment(a_vals, b_vals):
        asg = Assignment(spec)
        products = []
        for i, (a, b) in enumerate(zip(a_vals, b_vals)):
            asg.set_advice(adv[0], i, a)
            asg.set_advice(adv[0], n_muls + i, b)
            asg.set_advice(adv[0], base_m + i, a)
            asg.set_advice(adv[1], base_m + i, b)
            asg.set_advice(adv[2], base_m + i, a * b % R)
            products.append(a * b % R)
        asg.instance = [products]
        return asg

    return spec, make_assignment


def lookup_spec(k: int, table_values, lookups_rows: int):
    """A circuit with a dedicated lookup argument: advice column `a` must
    take values from a fixed table column. Exercises the lookup::Argument
    path the reference never tests."""
    spec = CircuitSpec(k)
    a = spec.advice_column()
    t = spec.fixed_column()
    q = spec.fixed_column()  # lookup gating: q*a in table (q*t)
    qa = spec.query(q, 0) * spec.query(a, 0)
    qt = spec.query(q, 0) * spec.query(t, 0)
    spec.lookup([qa], [qt])

    for i, v in enumerate(table_values):
        spec.assign_fixed(t, i, v)
    for i in range(lookups_rows):
        spec.assign_fixed(q, i, 1)

    def make_assignment(a_vals):
        asg = Assignment(spec)
        for i, v in enumerate(a_vals):
            asg.set_advice(a, i, v)
        asg.instance = []
        return asg

    return spec, make_assignment, a


def mac_range_spec(k: int, rows: int, n_pub: int):
    """The k=14-class benchmark workload (BASELINE config 2): a
    range-checked multiply-accumulate chain combining every argument kind
    the single-proof verifier exercises — a custom gate with a next-row
    rotation, a dedicated lookup argument (8-bit range table with its own
    gating selectors), copy constraints through the permutation argument,
    and an instance column of accumulator checkpoints.

    Layout: rows [0, rows): s_mac=1 gates acc[r+1] = acc[r] + a[r]*b[r];
    q_in=1 range-checks a[r] against the fixed 8-bit table t (rows 0..255,
    gated by q_t). n_pub accumulator checkpoints (every rows//n_pub-th acc
    cell) are copied into the instance column.
    """
    spec = CircuitSpec(k)
    a = spec.advice_column()
    b = spec.advice_column()
    acc = spec.advice_column()
    inst = spec.instance_column()
    s_mac = spec.fixed_column()
    q_in = spec.fixed_column()
    q_t = spec.fixed_column()
    t = spec.fixed_column()
    spec.enable_equality(acc)
    spec.enable_equality(inst)

    a_e = spec.query(a, 0)
    b_e = spec.query(b, 0)
    acc_e = spec.query(acc, 0)
    acc_n = spec.query(acc, 1)  # next-row rotation: advice opened at ωx too
    spec.gate(spec.query(s_mac, 0) * (acc_e + a_e * b_e - acc_n))
    spec.lookup([spec.query(q_in, 0) * a_e],
                [spec.query(q_t, 0) * spec.query(t, 0)])

    for i in range(256):
        spec.assign_fixed(t, i, i)
        spec.assign_fixed(q_t, i, 1)
    for r in range(rows):
        spec.assign_fixed(s_mac, r, 1)
        spec.assign_fixed(q_in, r, 1)
    step = rows // n_pub
    pub_rows = [(i + 1) * step for i in range(n_pub)]
    for i, r in enumerate(pub_rows):
        spec.copy(acc, r, inst, i)

    def make_assignment(seed: int):
        """Deterministic witness from an integer seed; instance values are
        recomputable without proving (fixture packs store only proof
        bytes)."""
        import random

        rng = random.Random(seed)
        asg = Assignment(spec)
        acc_v = 0
        acc_col = [0] * (rows + 1)
        for r in range(rows):
            av = rng.getrandbits(8)
            bv = rng.getrandbits(64)
            asg.set_advice(a, r, av)
            asg.set_advice(b, r, bv)
            asg.set_advice(acc, r, acc_v)
            acc_v = (acc_v + av * bv) % R
            acc_col[r + 1] = acc_v
        asg.set_advice(acc, rows, acc_v)
        asg.instance = [[acc_col[r] for r in pub_rows]]
        return asg

    return spec, make_assignment


def shuffle_spec(k: int, width: int, rows: int):
    """Two-phase shuffle circuit in the spirit of tests/shuffle.rs: phase-0
    original columns, phase-1 shuffled columns, an in-circuit challenge, and
    a shuffle argument tying them together."""
    spec = CircuitSpec(k)
    orig = [spec.advice_column(phase=0) for _ in range(width)]
    shuf = [spec.advice_column(phase=1) for _ in range(width)]
    q = spec.fixed_column()
    challenge = spec.challenge(phase=0)

    # the in-circuit challenge scales both sides, exercising challenge
    # variables in compiled expressions (plonk/vk.rs:503-505 challenge range)
    q_e = spec.query(q, 0)
    inputs = [q_e * challenge * spec.query(c, 0) for c in orig]
    shuffles = [q_e * challenge * spec.query(c, 0) for c in shuf]
    spec.shuffle(inputs, shuffles)

    for i in range(rows):
        spec.assign_fixed(q, i, 1)

    def make_assignment(original_cols, permutation):
        """original_cols: [width][rows] values; permutation: row mapping for
        the shuffled copy."""
        asg = Assignment(spec)
        for c in range(width):
            for i in range(rows):
                asg.set_advice(orig[c], i, original_cols[c][i])

        def fill_phase1(challenges):
            for c in range(width):
                for i in range(rows):
                    asg.set_advice(shuf[c], i, original_cols[c][permutation[i]])

        asg.phase_fillers[1] = fill_phase1
        asg.instance = []
        return asg

    return spec, make_assignment
