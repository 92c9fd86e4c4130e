"""Upstream-circuit ingestion: the recursive Expression model and the
conversion compiler (the `serialize` crate's interop half).

An externally-described halo2 circuit arrives as the upstream
halo2_proofs shapes: a ConstraintSystem whose gates/lookups/shuffles are
RECURSIVE expression trees (Constant/Selector/Fixed/Advice/Instance/
Challenge/Negated/Sum/Product/Scaled) over (column, rotation) queries.
This module folds those trees into the verifier's flat-variable
SparsePolynomialF form and assembles a byte-identical VerifyingKey:

  * ``expression_transform`` — the recursive fold over the flat variable
    space advice‖fixed‖instance‖challenge, resolving (column, rotation) to
    query indices, with the virtual-selector panic
    (serialize/src/lib.rs:252-312).
  * ``convert_constraint_system`` — transform all expressions, then dedup
    coefficients into the shared pool in the exact traversal order
    gates → lookups (inputs, tables) → shuffles (inputs, shuffles)
    (serialize/src/lib.rs:38-225, index_element :366-373).
  * ``convert_verifier_key`` — upstream vk fields → verifier VerifyingKey
    (serialize/src/lib.rs:12-24).

The in-repo keygen (prover/keygen.py) emits the indexed form directly;
this is the path for circuits keygen'd OUTSIDE this framework.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..ops.constants import R
from .columns import ADVICE, FIXED, INSTANCE, Column
from .domain import EvaluationDomain
from .multilinear import SparsePolynomialF
from .vk import ConstraintSystem, LookupArgument, PermutationArgument
from .vk import PermutationVerifyingKey, ShuffleArgument, VerifyingKey


class VirtualSelectorError(Exception):
    """Mirror of the transform's panic: `Expression::Selector` must not
    survive into conversion — upstream keygen replaces virtual selectors
    with fixed columns during optimization (serialize/src/lib.rs:269)."""


# ------------------------------------------------------------- expressions
class Expression:
    """Base of the recursive upstream expression enum
    (halo2_proofs::plonk::Expression). Operators build the tree the same
    way circuit code does in Rust: +, -, *, unary -, int scaling."""

    __slots__ = ()

    def __add__(self, other):
        return Sum(self, _lift(other))

    def __radd__(self, other):
        return Sum(_lift(other), self)

    def __sub__(self, other):
        return Sum(self, Negated(_lift(other)))

    def __rsub__(self, other):
        return Sum(_lift(other), Negated(self))

    def __neg__(self):
        return Negated(self)

    def __mul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other % R)
        return Product(self, _lift(other))

    def __rmul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other % R)
        return Product(_lift(other), self)


def _lift(v) -> Expression:
    if isinstance(v, Expression):
        return v
    if isinstance(v, int):
        return Constant(v % R)
    raise TypeError(f"cannot lift {type(v).__name__} into an Expression")


@dataclass(frozen=True)
class Constant(Expression):
    value: int


@dataclass(frozen=True)
class Selector(Expression):
    """A virtual selector. Present only pre-optimization; conversion
    rejects it (the panic at serialize/src/lib.rs:269)."""

    index: int


@dataclass(frozen=True)
class FixedQuery(Expression):
    column_index: int
    rotation: int = 0


@dataclass(frozen=True)
class AdviceQuery(Expression):
    column_index: int
    rotation: int = 0
    phase: int = 0


@dataclass(frozen=True)
class InstanceQuery(Expression):
    column_index: int
    rotation: int = 0


@dataclass(frozen=True)
class Challenge(Expression):
    index: int
    phase: int = 0


@dataclass(frozen=True)
class Negated(Expression):
    expr: Expression


@dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression


@dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression


@dataclass(frozen=True)
class Scaled(Expression):
    expr: Expression
    scalar: int


# ------------------------------------------------- upstream-shaped inputs
@dataclass
class UpstreamConstraintSystem:
    """The post-keygen upstream ConstraintSystem surface the converter
    consumes — the accessor set convert_constraint_system reads
    (serialize/src/lib.rs:186-213). Queries are (column_index, rotation)
    pairs ((index, phase, rotation) for advice), already enumerated by
    upstream keygen in query-index order."""

    num_fixed_columns: int = 0
    num_advice_columns: int = 0
    num_instance_columns: int = 0
    num_selectors: int = 0
    num_challenges: int = 0
    advice_column_phase: list = dc_field(default_factory=list)
    challenge_phase: list = dc_field(default_factory=list)
    gates: list = dc_field(default_factory=list)  # [[Expression, ...], ...]
    advice_queries: list = dc_field(default_factory=list)  # [(idx,phase,rot)]
    fixed_queries: list = dc_field(default_factory=list)   # [(idx, rot)]
    instance_queries: list = dc_field(default_factory=list)
    permutation_columns: list = dc_field(default_factory=list)  # [Column]
    lookups: list = dc_field(default_factory=list)   # [(inputs, tables)]
    shuffles: list = dc_field(default_factory=list)  # [(inputs, shuffles)]


@dataclass
class UpstreamVerifyingKey:
    """The upstream VerifyingKey fields convert_verifier_key reads
    (serialize/src/lib.rs:12-24)."""

    k: int
    cs_degree: int
    fixed_commitments: list
    permutation_commitments: list
    cs: UpstreamConstraintSystem
    transcript_repr: int
    selectors: list = dc_field(default_factory=list)


# ---------------------------------------------------- query-index lookup
def get_advice_query_index(cs: UpstreamConstraintSystem, column_index: int,
                           phase: int, rotation: int) -> int:
    """serialize/src/lib.rs:316-331 (panics on a non-existent query)."""
    for index, (idx, ph, rot) in enumerate(cs.advice_queries):
        if (idx, ph, rot) == (column_index, phase, rotation):
            return index
    raise KeyError("get_advice_query_index called for non-existent query")


def get_fixed_query_index(cs: UpstreamConstraintSystem, column_index: int,
                          rotation: int) -> int:
    for index, (idx, rot) in enumerate(cs.fixed_queries):
        if (idx, rot) == (column_index, rotation):
            return index
    raise KeyError("get_fixed_query_index called for non-existent query")


def get_instance_query_index(cs: UpstreamConstraintSystem, column_index: int,
                             rotation: int) -> int:
    for index, (idx, rot) in enumerate(cs.instance_queries):
        if (idx, rot) == (column_index, rotation):
            return index
    raise KeyError("get_instance_query_index called for non-existent query")


# ----------------------------------------------------------- the compiler
def expression_transform(cs: UpstreamConstraintSystem,
                         expr: Expression) -> SparsePolynomialF:
    """Fold a recursive Expression into a SparsePolynomialF over the flat
    variable space advice‖fixed‖instance‖challenge
    (serialize/src/lib.rs:250-312; variable order matches
    IndexedExpressionPoly.evaluate and the on-chain expression.move)."""
    advice_range = len(cs.advice_queries)
    fixed_range = advice_range + len(cs.fixed_queries)
    instance_range = fixed_range + len(cs.instance_queries)
    challenge_range = instance_range + len(cs.challenge_phase)
    nv = challenge_range

    def rec(e: Expression) -> SparsePolynomialF:
        if isinstance(e, Constant):
            return SparsePolynomialF.constant(nv, e.value % R)
        if isinstance(e, Selector):
            raise VirtualSelectorError(
                "virtual selectors are removed during optimization"
            )
        if isinstance(e, FixedQuery):
            qi = get_fixed_query_index(cs, e.column_index, e.rotation)
            return SparsePolynomialF.variable(nv, advice_range + qi)
        if isinstance(e, AdviceQuery):
            qi = get_advice_query_index(cs, e.column_index, e.phase,
                                        e.rotation)
            return SparsePolynomialF.variable(nv, qi)
        if isinstance(e, InstanceQuery):
            qi = get_instance_query_index(cs, e.column_index, e.rotation)
            return SparsePolynomialF.variable(nv, fixed_range + qi)
        if isinstance(e, Challenge):
            return SparsePolynomialF.variable(nv, instance_range + e.index)
        if isinstance(e, Negated):
            return -rec(e.expr)
        if isinstance(e, Sum):
            return rec(e.a) + rec(e.b)
        if isinstance(e, Product):
            return rec(e.a) * rec(e.b)
        if isinstance(e, Scaled):
            return rec(e.expr) * SparsePolynomialF.constant(
                nv, e.scalar % R)
        raise TypeError(f"not an Expression: {type(e).__name__}")

    return rec(expr)


def convert_constraint_system(
        ucs: UpstreamConstraintSystem) -> ConstraintSystem:
    """serialize/src/lib.rs:38-225: transform every expression, then dedup
    coefficients into the shared pool — pool insertion order is gates
    (flattened across multi-polynomial gates), then per lookup all inputs
    then all tables, then per shuffle all inputs then all shuffles. The
    order is part of the byte format (coeff indices are serialized)."""
    compiled_gates = [expression_transform(ucs, poly)
                      for gate in ucs.gates for poly in gate]
    compiled_lookups = [
        ([expression_transform(ucs, e) for e in inputs],
         [expression_transform(ucs, e) for e in tables])
        for inputs, tables in ucs.lookups
    ]
    compiled_shuffles = [
        ([expression_transform(ucs, e) for e in inputs],
         [expression_transform(ucs, e) for e in shufs])
        for inputs, shufs in ucs.shuffles
    ]

    pool: list = []
    gates = [g.index_into(pool) for g in compiled_gates]
    lookups = [
        LookupArgument([e.index_into(pool) for e in inputs],
                       [e.index_into(pool) for e in tables])
        for inputs, tables in compiled_lookups
    ]
    shuffles = [
        ShuffleArgument([e.index_into(pool) for e in inputs],
                        [e.index_into(pool) for e in shufs])
        for inputs, shufs in compiled_shuffles
    ]

    num_advice_queries = [0] * ucs.num_advice_columns
    for idx, _ph, _rot in ucs.advice_queries:
        num_advice_queries[idx] += 1

    cs = ConstraintSystem(
        num_fixed_columns=ucs.num_fixed_columns,
        num_advice_columns=ucs.num_advice_columns,
        num_instance_columns=ucs.num_instance_columns,
        num_selectors=ucs.num_selectors,
        num_challenges=ucs.num_challenges,
        advice_column_phase=list(ucs.advice_column_phase),
        challenge_phase=list(ucs.challenge_phase),
        gates=gates,
        num_advice_queries=num_advice_queries,
        advice_queries=[(Column(ADVICE, idx, ph), rot)
                        for idx, ph, rot in ucs.advice_queries],
        instance_queries=[(Column(INSTANCE, idx), rot)
                          for idx, rot in ucs.instance_queries],
        fixed_queries=[(Column(FIXED, idx), rot)
                       for idx, rot in ucs.fixed_queries],
        permutation=PermutationArgument(list(ucs.permutation_columns)),
        lookups=lookups,
        shuffles=shuffles,
        coeff_vals=pool,
    )
    cs.validate_bounds()
    return cs


def convert_verifier_key(uvk: UpstreamVerifyingKey) -> VerifyingKey:
    """serialize/src/lib.rs:12-24."""
    cs = convert_constraint_system(uvk.cs)
    return VerifyingKey(
        domain=EvaluationDomain(uvk.cs_degree, uvk.k),
        fixed_commitments=list(uvk.fixed_commitments),
        permutation=PermutationVerifyingKey(
            list(uvk.permutation_commitments)),
        cs=cs,
        cs_degree=uvk.cs_degree,
        transcript_repr=uvk.transcript_repr,
        selectors=list(uvk.selectors),
    )
