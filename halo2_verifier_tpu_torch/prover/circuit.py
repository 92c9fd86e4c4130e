"""Minimal circuit description + witness API for the test-only prover.

This replaces the upstream halo2_proofs frontend (which the reference's
tests depend on, tests/helpers.rs:18-85) with a compact spec: columns,
queries, gate expressions, copy constraints, lookups and shuffles. Gates are
authored as expression trees and compiled into the flat-variable
SparsePolynomialF form exactly like expression_transform
(serialize/src/lib.rs:252-312).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.constants import R
from ..protocol.columns import ADVICE, FIXED, INSTANCE, Column
from ..protocol.multilinear import SparsePolynomialF


@dataclass(frozen=True)
class Expr:
    """Tiny expression AST; compiled after configure when query counts are
    final."""

    op: str           # 'const' | 'var' | 'challenge' | 'add' | 'mul' | 'neg'
    args: tuple = ()
    value: int = 0    # const value / challenge index
    var: tuple = None  # ('advice'|'fixed'|'instance', query_index)

    def __add__(self, other):
        return Expr("add", (self, _lift(other)))

    def __radd__(self, other):
        return _lift(other) + self

    def __sub__(self, other):
        return self + (-_lift(other))

    def __rsub__(self, other):
        return _lift(other) + (-self)

    def __neg__(self):
        return Expr("neg", (self,))

    def __mul__(self, other):
        return Expr("mul", (self, _lift(other)))

    def __rmul__(self, other):
        return _lift(other) * self


def _lift(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Expr("const", value=v % R)


class CircuitSpec:
    def __init__(self, k: int):
        self.k = k
        self.n = 1 << k
        self.advice_phase: list[int] = []
        self.num_fixed = 0
        self.num_instance = 0
        self.challenge_phase: list[int] = []
        self.advice_queries: list[tuple[Column, int]] = []
        self.fixed_queries: list[tuple[Column, int]] = []
        self.instance_queries: list[tuple[Column, int]] = []
        self.gates: list[Expr] = []
        self.permutation_columns: list[Column] = []
        self.lookups: list[tuple[list[Expr], list[Expr]]] = []
        self.shuffles: list[tuple[list[Expr], list[Expr]]] = []
        # structural assignment (constant across proofs)
        self.fixed_values: list[list[int]] = []
        self.copies: list[tuple[Column, int, Column, int]] = []

    # ------------------------------------------------------------ configure
    def advice_column(self, phase: int = 0) -> Column:
        col = Column(ADVICE, len(self.advice_phase), phase)
        self.advice_phase.append(phase)
        return col

    def fixed_column(self) -> Column:
        col = Column(FIXED, self.num_fixed)
        self.num_fixed += 1
        self.fixed_values.append([0] * self.n)
        return col

    def instance_column(self) -> Column:
        col = Column(INSTANCE, self.num_instance)
        self.num_instance += 1
        return col

    def challenge(self, phase: int) -> Expr:
        idx = len(self.challenge_phase)
        self.challenge_phase.append(phase)
        return Expr("challenge", value=idx)

    def enable_equality(self, col: Column) -> None:
        if col not in self.permutation_columns:
            self.permutation_columns.append(col)

    def query(self, col: Column, rot: int = 0) -> Expr:
        table = {
            ADVICE: self.advice_queries,
            FIXED: self.fixed_queries,
            INSTANCE: self.instance_queries,
        }[col.kind]
        key = (col, rot)
        if key in table:
            idx = table.index(key)
        else:
            idx = len(table)
            table.append(key)
        return Expr("var", var=(col.kind, idx))

    def gate(self, expr: Expr) -> None:
        self.gates.append(expr)

    def lookup(self, inputs: list[Expr], tables: list[Expr]) -> None:
        self.lookups.append((inputs, tables))

    def shuffle(self, inputs: list[Expr], shuffles: list[Expr]) -> None:
        self.shuffles.append((inputs, shuffles))

    # structural assignment -------------------------------------------------
    def assign_fixed(self, col: Column, row: int, value: int) -> None:
        self.fixed_values[col.index][row] = value % R

    def copy(self, col_a: Column, row_a: int, col_b: Column, row_b: int) -> None:
        self.enable_equality(col_a)
        self.enable_equality(col_b)
        self.copies.append((col_a, row_a, col_b, row_b))

    # ------------------------------------------------------------- compile
    def finalize_queries(self) -> None:
        """Ensure protocol invariants: every permutation column queried at
        rot 0; exactly one query per fixed/instance column (the reference
        codec requires those counts to match, vk.rs:310-321)."""
        for col in self.permutation_columns:
            self.query(col, 0)
        for i in range(self.num_fixed):
            self.query(Column(FIXED, i), 0)
        for i in range(self.num_instance):
            self.query(Column(INSTANCE, i), 0)
        assert len(self.fixed_queries) == self.num_fixed, (
            "reference codec requires exactly one query per fixed column"
        )
        assert len(self.instance_queries) == self.num_instance, (
            "reference codec requires exactly one query per instance column"
        )

    def num_vars(self) -> int:
        return (
            len(self.advice_queries)
            + len(self.fixed_queries)
            + len(self.instance_queries)
            + len(self.challenge_phase)
        )

    def compile_expr(self, expr: Expr) -> SparsePolynomialF:
        """expression_transform: flat variable space advice || fixed ||
        instance || challenges."""
        nv = self.num_vars()
        advice_range = len(self.advice_queries)
        fixed_range = advice_range + len(self.fixed_queries)
        instance_range = fixed_range + len(self.instance_queries)

        def rec(e: Expr) -> SparsePolynomialF:
            if e.op == "const":
                return SparsePolynomialF.constant(nv, e.value)
            if e.op == "var":
                kind, idx = e.var
                base = {"advice": 0, "fixed": advice_range,
                        "instance": fixed_range}[kind]
                return SparsePolynomialF.variable(nv, base + idx)
            if e.op == "challenge":
                return SparsePolynomialF.variable(nv, instance_range + e.value)
            if e.op == "add":
                return rec(e.args[0]) + rec(e.args[1])
            if e.op == "neg":
                return -rec(e.args[0])
            if e.op == "mul":
                return rec(e.args[0]) * rec(e.args[1])
            raise ValueError(e.op)

        return rec(expr)


@dataclass
class Assignment:
    """Per-proof witness: advice values (possibly phase-dependent) and
    instance values."""

    spec: CircuitSpec
    instance: list[list[int]] = field(default_factory=list)
    advice: list[list[int]] = None
    # advice filled lazily per phase: fn(challenges: dict[idx->Fr]) -> None
    phase_fillers: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.advice is None:
            self.advice = [
                [0] * self.spec.n for _ in self.spec.advice_phase
            ]

    def set_advice(self, col: Column, row: int, value: int) -> None:
        self.advice[col.index][row] = value % R
