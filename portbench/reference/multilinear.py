"""Frozen copy of halo2_verifier_tpu/protocol/multilinear.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Sparse multivariate gate-expression polynomials.

Mirrors the reference's arkworks-style representation (poly/multilinear.rs)
and the u16-coefficient-indexed variant (plonk/vk.rs:462-556): a gate is a
sum of terms ``coeff_pool[ci] * prod_j var[vj]^pj`` over a flat variable
space ordered advice-queries || fixed-queries || instance-queries ||
challenges (serialize/src/lib.rs:252-312).

Beyond parity with the reference's scalar fold-evaluation, this module
compiles the term list into flat index/power arrays so the device path can
evaluate *all* gates for a whole proof batch as one padded tensor program
(gather -> pow -> prod -> segment-sum), which is the TPU-native form.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .serde import ByteReader, ByteWriter

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


# A term is (coeff_index:int, vars:tuple[(var:int, pow:int), ...]); vars are
# kept sorted by variable index as SparseTerm::new does (poly/multilinear.rs:324+).
def make_term(vars_pows) -> tuple:
    merged: dict[int, int] = {}
    for v, p in vars_pows:
        if p:
            merged[v] = merged.get(v, 0) + p
    return tuple(sorted(merged.items()))


@dataclass
class IndexedExpressionPoly:
    """SparsePolynomial<u16, SparseTerm> (plonk/vk.rs:462)."""

    num_vars: int
    terms: list  # [(coeff_idx:int, term:tuple[(var,pow),...])]

    def evaluate(self, coeffs, advice_evals, fixed_evals, instance_evals,
                 challenges) -> int:
        """Scalar host evaluation (plonk/vk.rs:478-512).

        The variable space partition is advice -> fixed -> instance ->
        challenge, in that order.
        """
        advice_range = len(advice_evals)
        fixed_range = advice_range + len(fixed_evals)
        instance_range = fixed_range + len(instance_evals)

        def var(idx: int) -> int:
            if idx < advice_range:
                return advice_evals[idx]
            if idx < fixed_range:
                return fixed_evals[idx - advice_range]
            if idx < instance_range:
                return instance_evals[idx - fixed_range]
            return challenges[idx - instance_range]

        acc = 0
        for coeff_idx, term in self.terms:
            prod = coeffs[coeff_idx]
            for v, p in term:
                prod = prod * pow(var(v), p, R) % R
            acc = (acc + prod) % R
        return acc

    def degree(self) -> int:
        return max((sum(p for _, p in t) for _, t in self.terms), default=0)

    # codec (plonk/vk.rs:514-546) ------------------------------------------
    def write(self, w: ByteWriter) -> None:
        w.write_u32(self.num_vars)
        w.write_u32(len(self.terms))
        for coeff_idx, term in self.terms:
            w.write_u16(coeff_idx)
            w.write_u32(len(term))
            for v, p in term:
                w.write_u32(v)
                w.write_u32(p)

    @classmethod
    def read(cls, r: ByteReader) -> "IndexedExpressionPoly":
        num_vars = r.read_u32()
        num_terms = r.read_u32()
        terms = []
        for _ in range(num_terms):
            coeff_idx = r.read_u16()
            term_len = r.read_u32()
            term = tuple((r.read_u32(), r.read_u32()) for _ in range(term_len))
            terms.append((coeff_idx, term))
        return cls(num_vars, terms)

    def max_term_len(self) -> int:
        return max((len(t) for _, t in self.terms), default=0)


@dataclass
class SparsePolynomialF:
    """SparsePolynomial<F, SparseTerm> with field coefficients — the
    pre-indexing form produced by expression transformation
    (serialize/src/lib.rs:252-312)."""

    num_vars: int
    terms: list = field(default_factory=list)  # [(coeff:int, term:tuple)]

    @classmethod
    def constant(cls, num_vars: int, c: int) -> "SparsePolynomialF":
        return cls(num_vars, [(c % R, tuple())] if c % R else [])

    @classmethod
    def variable(cls, num_vars: int, var: int) -> "SparsePolynomialF":
        return cls(num_vars, [(1, ((var, 1),))])

    def _normalized(self, terms) -> "SparsePolynomialF":
        agg: dict[tuple, int] = {}
        for c, t in terms:
            agg[t] = (agg.get(t, 0) + c) % R
        out = [(c, t) for t, c in sorted(agg.items()) if c]
        return SparsePolynomialF(self.num_vars, out)

    def __add__(self, other):
        return self._normalized(self.terms + other.terms)

    def __neg__(self):
        return SparsePolynomialF(self.num_vars, [(-c % R, t) for c, t in self.terms])

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other):
        if isinstance(other, int):
            return self._normalized([(c * other % R, t) for c, t in self.terms])
        terms = []
        for c1, t1 in self.terms:
            for c2, t2 in other.terms:
                terms.append((c1 * c2 % R, make_term(list(t1) + list(t2))))
        return self._normalized(terms)

    def index_into(self, pool: list) -> IndexedExpressionPoly:
        """Dedup coefficients into a shared pool, yielding u16 indices
        (serialize/src/lib.rs:52-69, index_element :366-373)."""
        idx_terms = []
        for c, t in self.terms:
            try:
                ci = pool.index(c)
            except ValueError:
                ci = len(pool)
                pool.append(c)
            assert ci < (1 << 16), "coefficient pool exceeds u16 index space"
            idx_terms.append((ci, t))
        return IndexedExpressionPoly(self.num_vars, idx_terms)
