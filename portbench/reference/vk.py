"""Frozen copy of halo2_verifier_tpu/protocol/vk.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

VerifyingKey and ConstraintSystem with the reference's exact byte codec.

Reference: plonk/vk.rs. The serialized layout (all ints big-endian, curve
points/fields per SerdeFormat as in helpers.rs) is reproduced bit-exactly:

VerifyingKey::write (vk.rs:41-64):
    u32 k | u32 #fixed_commitments | fixed commitments
    u32 cs_degree | ConstraintSystem | permutation vk commitments
    selector bitmaps ((1<<k)/8 bytes each) | transcript_repr

ConstraintSystem::write (vk.rs:214-272):
    u32 x9 counts | advice/challenge phases (u8 each)
    u32 num_advice_queries per advice column
    advice queries (u32 idx, u8 phase, i32 rot)
    instance queries (u32 idx, i32 rot) | fixed queries (u32 idx, i32 rot)
    permutation argument | gates | lookups | shuffles | coeff_vals
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import hostcurve as hc
from . import hostfield as hf
from .serde import ByteReader, ByteWriter, pack_bits, unpack_bits
from .columns import ADVICE, FIXED, INSTANCE, Column
from .domain import EvaluationDomain
from .multilinear import IndexedExpressionPoly

# SerdeFormat (helpers.rs:7-19)
PROCESSED = "processed"
RAW_BYTES = "raw_bytes"
RAW_BYTES_UNCHECKED = "raw_bytes_unchecked"


def write_point(w: ByteWriter, pt, fmt: str) -> None:
    w.write_all(hc.g1_to_bytes(pt) if fmt == PROCESSED else hc.g1_to_raw(pt))


def read_point(r: ByteReader, fmt: str):
    if fmt == PROCESSED:
        return hc.g1_from_bytes(r.read_exact(32))
    return hc.g1_from_raw(r.read_exact(64), check=(fmt == RAW_BYTES))


def write_scalar(w: ByteWriter, s: int, fmt: str) -> None:
    w.write_all(hf.to_repr(s) if fmt == PROCESSED else hf.fr_to_raw(s))


def read_scalar(r: ByteReader, fmt: str) -> int:
    if fmt == PROCESSED:
        return hf.from_repr(r.read_exact(32), hf.R)
    return hf.fr_from_raw(r.read_exact(32), check=(fmt == RAW_BYTES))


@dataclass
class PermutationArgument:
    """plonk/permutation.rs:19-44 — the committed columns of the argument."""

    columns: list  # list[Column]

    def write(self, w: ByteWriter) -> None:
        w.write_u32(len(self.columns))
        for col in self.columns:
            col.write(w)

    @classmethod
    def read(cls, r: ByteReader) -> "PermutationArgument":
        return cls([Column.read(r) for _ in range(r.read_u32())])


@dataclass
class PermutationVerifyingKey:
    """sigma commitments (plonk/permutation.rs:136-181)."""

    commitments: list

    def write(self, w: ByteWriter, fmt: str) -> None:
        for c in self.commitments:
            write_point(w, c, fmt)

    @classmethod
    def read(cls, r: ByteReader, argument: PermutationArgument, fmt: str):
        return cls([read_point(r, fmt) for _ in argument.columns])


@dataclass
class LookupArgument:
    """plonk/lookup.rs:17-80; expressions interleaved input/table on the wire."""

    input_expressions: list
    table_expressions: list

    def write(self, w: ByteWriter) -> None:
        w.write_u32(len(self.input_expressions))
        for e in self.input_expressions:
            e.write(w)
        for e in self.table_expressions:
            e.write(w)

    @classmethod
    def read(cls, r: ByteReader) -> "LookupArgument":
        n = r.read_u32()
        inputs, tables = [], []
        for _ in range(n):
            inputs.append(IndexedExpressionPoly.read(r))
            tables.append(IndexedExpressionPoly.read(r))
        return cls(inputs, tables)


@dataclass
class ShuffleArgument:
    """plonk/shuffle.rs:17-114; same wire shape as lookups."""

    input_expressions: list
    shuffle_expressions: list

    def write(self, w: ByteWriter) -> None:
        w.write_u32(len(self.input_expressions))
        for e in self.input_expressions:
            e.write(w)
        for e in self.shuffle_expressions:
            e.write(w)

    @classmethod
    def read(cls, r: ByteReader) -> "ShuffleArgument":
        n = r.read_u32()
        inputs, shuffles = [], []
        for _ in range(n):
            inputs.append(IndexedExpressionPoly.read(r))
            shuffles.append(IndexedExpressionPoly.read(r))
        return cls(inputs, shuffles)


@dataclass
class ConstraintSystem:
    num_fixed_columns: int = 0
    num_advice_columns: int = 0
    num_instance_columns: int = 0
    num_selectors: int = 0
    num_challenges: int = 0
    advice_column_phase: list = field(default_factory=list)
    challenge_phase: list = field(default_factory=list)
    gates: list = field(default_factory=list)  # list[IndexedExpressionPoly]
    num_advice_queries: list = field(default_factory=list)
    advice_queries: list = field(default_factory=list)  # [(Column, rot)]
    instance_queries: list = field(default_factory=list)
    fixed_queries: list = field(default_factory=list)
    permutation: PermutationArgument = field(
        default_factory=lambda: PermutationArgument([])
    )
    lookups: list = field(default_factory=list)
    shuffles: list = field(default_factory=list)
    coeff_vals: list = field(default_factory=list)  # shared Fr pool

    # ------------------------------------------------------------- queries
    def blinding_factors(self) -> int:
        """vk.rs:396-401: max(3, max advice queries) + 2."""
        factors = max(self.num_advice_queries, default=1)
        if not self.num_advice_queries:
            factors = 1
        return max(3, factors) + 2

    def phases(self):
        """vk.rs:403-411."""
        max_phase = max(self.advice_column_phase, default=0)
        return range(max_phase + 1)

    def get_any_query_index(self, column: Column, rot: int) -> int:
        """vk.rs:413-455."""
        table = {
            ADVICE: self.advice_queries,
            FIXED: self.fixed_queries,
            INSTANCE: self.instance_queries,
        }[column.kind]
        for i, (col, r) in enumerate(table):
            if col == column and r == rot:
                return i
        raise KeyError(f"query index not found for {column} rot {rot}")

    def validate_bounds(self) -> None:
        """Error::BoundsFailure (plonk/mod.rs:25,46): reject any index that
        points outside the circuit's column/variable/coefficient space
        before the backend dereferences it. Run at deserialization so a
        corrupted or adversarial vk fails loudly instead of evaluating
        garbage (or raising a bare IndexError deep in the replay)."""
        # lazy: kzg.py imports this module at load time (serde constants)
        from .kzg import BoundsFailure

        counts = {
            ADVICE: self.num_advice_columns,
            FIXED: self.num_fixed_columns,
            INSTANCE: self.num_instance_columns,
        }
        kind_names = {ADVICE: "advice", FIXED: "fixed", INSTANCE: "instance"}

        def check_col(col, where):
            if col.index >= counts[col.kind]:
                raise BoundsFailure(
                    f"{where}: {kind_names[col.kind]} column index "
                    f"{col.index} >= {counts[col.kind]}"
                )

        for col, _rot in self.advice_queries:
            check_col(col, "advice query")
        for col, _rot in self.instance_queries:
            check_col(col, "instance query")
        for col, _rot in self.fixed_queries:
            check_col(col, "fixed query")
        for col in self.permutation.columns:
            check_col(col, "permutation argument")
        # gates/lookups/shuffles index the flat variable space
        # advice‖fixed‖instance‖challenge (vk.rs:478-512) and the shared
        # coefficient pool
        num_vars = (len(self.advice_queries) + len(self.fixed_queries)
                    + len(self.instance_queries) + self.num_challenges)
        num_coeffs = len(self.coeff_vals)

        def check_poly(poly, where):
            for coeff_idx, term in poly.terms:
                if coeff_idx >= num_coeffs:
                    raise BoundsFailure(
                        f"{where}: coefficient index {coeff_idx} >= "
                        f"{num_coeffs}"
                    )
                for v, _p in term:
                    if v >= num_vars:
                        raise BoundsFailure(
                            f"{where}: variable index {v} >= {num_vars}"
                        )

        for gate in self.gates:
            check_poly(gate, "gate")
        for lookup in self.lookups:
            for poly in list(lookup.input_expressions) + list(
                    lookup.table_expressions):
                check_poly(poly, "lookup")
        for shuffle in self.shuffles:
            for poly in list(shuffle.input_expressions) + list(
                    shuffle.shuffle_expressions):
                check_poly(poly, "shuffle")

    # --------------------------------------------------------------- codec
    def write(self, w: ByteWriter, fmt: str) -> None:
        w.write_u32(self.num_fixed_columns)
        w.write_u32(self.num_advice_columns)
        w.write_u32(self.num_instance_columns)
        w.write_u32(self.num_selectors)
        w.write_u32(self.num_challenges)
        w.write_u32(len(self.gates))
        w.write_u32(len(self.lookups))
        w.write_u32(len(self.shuffles))
        w.write_u32(len(self.coeff_vals))
        for phase in self.advice_column_phase:
            w.write_u8(phase)
        for phase in self.challenge_phase:
            w.write_u8(phase)
        for n in self.num_advice_queries:
            w.write_u32(n)
        for col, rot in self.advice_queries:
            w.write_u32(col.index)
            w.write_u8(col.phase)
            w.write_i32(rot)
        for col, rot in self.instance_queries:
            w.write_u32(col.index)
            w.write_i32(rot)
        for col, rot in self.fixed_queries:
            w.write_u32(col.index)
            w.write_i32(rot)
        self.permutation.write(w)
        for gate in self.gates:
            gate.write(w)
        for lookup in self.lookups:
            lookup.write(w)
        for shuffle in self.shuffles:
            shuffle.write(w)
        for v in self.coeff_vals:
            write_scalar(w, v, fmt)

    @classmethod
    def read(cls, r: ByteReader, fmt: str) -> "ConstraintSystem":
        cs = cls()
        cs.num_fixed_columns = r.read_u32()
        cs.num_advice_columns = r.read_u32()
        cs.num_instance_columns = r.read_u32()
        cs.num_selectors = r.read_u32()
        cs.num_challenges = r.read_u32()
        num_gates = r.read_u32()
        num_lookups = r.read_u32()
        num_shuffles = r.read_u32()
        num_coeff_vals = r.read_u32()
        cs.advice_column_phase = [r.read_u8() for _ in range(cs.num_advice_columns)]
        cs.challenge_phase = [r.read_u8() for _ in range(cs.num_challenges)]
        cs.num_advice_queries = [r.read_u32() for _ in range(cs.num_advice_columns)]
        total_advice_queries = sum(cs.num_advice_queries)
        for _ in range(total_advice_queries):
            index = r.read_u32()
            phase = r.read_u8()
            rot = r.read_i32()
            cs.advice_queries.append((Column(ADVICE, index, phase), rot))
        # NOTE (vk.rs:310-321): the wire format stores one instance query per
        # instance column and one fixed query per fixed column.
        for _ in range(cs.num_instance_columns):
            cs.instance_queries.append((Column(INSTANCE, r.read_u32()), r.read_i32()))
        for _ in range(cs.num_fixed_columns):
            cs.fixed_queries.append((Column(FIXED, r.read_u32()), r.read_i32()))
        cs.permutation = PermutationArgument.read(r)
        cs.gates = [IndexedExpressionPoly.read(r) for _ in range(num_gates)]
        cs.lookups = [LookupArgument.read(r) for _ in range(num_lookups)]
        cs.shuffles = [ShuffleArgument.read(r) for _ in range(num_shuffles)]
        cs.coeff_vals = [read_scalar(r, fmt) for _ in range(num_coeff_vals)]
        return cs


@dataclass
class VerifyingKey:
    domain: EvaluationDomain
    fixed_commitments: list
    permutation: PermutationVerifyingKey
    cs: ConstraintSystem
    cs_degree: int
    transcript_repr: int
    selectors: list  # list[list[bool]]

    def hash_into(self, transcript) -> None:
        """vk.rs:145-152."""
        transcript.common_scalar(self.transcript_repr)

    # --------------------------------------------------------------- codec
    def write(self, w: ByteWriter, fmt: str) -> None:
        w.write_u32(self.domain.k)
        w.write_u32(len(self.fixed_commitments))
        for c in self.fixed_commitments:
            write_point(w, c, fmt)
        w.write_u32(self.cs_degree)
        self.cs.write(w, fmt)
        self.permutation.write(w, fmt)
        for selector in self.selectors:
            w.write_all(pack_bits(selector))
        write_scalar(w, self.transcript_repr, fmt)

    @classmethod
    def read(cls, r: ByteReader, fmt: str) -> "VerifyingKey":
        k = r.read_u32()
        num_fixed = r.read_u32()
        fixed_commitments = [read_point(r, fmt) for _ in range(num_fixed)]
        cs_degree = r.read_u32()
        cs = ConstraintSystem.read(r, fmt)
        cs.validate_bounds()  # Error::BoundsFailure before any dereference
        domain = EvaluationDomain(cs_degree, k)
        permutation = PermutationVerifyingKey.read(r, cs.permutation, fmt)
        selectors = []
        n = 1 << k
        for _ in range(cs.num_selectors):
            selectors.append(unpack_bits(r.read_exact((n + 7) // 8), n))
        transcript_repr = read_scalar(r, fmt)
        return cls(domain, fixed_commitments, permutation, cs, cs_degree,
                   transcript_repr, selectors)

    def to_bytes(self, fmt: str = PROCESSED) -> bytes:
        w = ByteWriter()
        self.write(w, fmt)
        return w.getvalue()

    def content_digest(self) -> bytes:
        """sha256 of the serialized vk, cached. Stable cache key for
        per-vk compiled artifacts (unlike id(vk), which CPython recycles
        after the object is collected)."""
        d = getattr(self, "_content_digest", None)
        if d is None:
            import hashlib

            d = hashlib.sha256(self.to_bytes()).digest()
            self._content_digest = d
        return d

    @classmethod
    def from_bytes(cls, data: bytes, fmt: str = PROCESSED) -> "VerifyingKey":
        return cls.read(ByteReader(data), fmt)
