"""Frozen copy of halo2_verifier_tpu/protocol/columns.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Typed circuit columns (reference: plonk/circuit.rs).

A column is (kind, index, phase); kind is one of 'advice' / 'fixed' /
'instance', phase only meaningful for advice. The 5-byte wire encoding uses
255=Fixed, 254=Instance, 0..2=Advice phase (plonk/circuit.rs:36-70).
"""

from __future__ import annotations

from dataclasses import dataclass

from .serde import ByteReader, ByteWriter

ADVICE = "advice"
FIXED = "fixed"
INSTANCE = "instance"


@dataclass(frozen=True)
class Column:
    kind: str
    index: int
    phase: int = 0

    def write(self, w: ByteWriter) -> None:
        w.write_u32(self.index)
        if self.kind == FIXED:
            w.write_u8(255)
        elif self.kind == INSTANCE:
            w.write_u8(254)
        else:
            w.write_u8(self.phase)

    @classmethod
    def read(cls, r: ByteReader) -> "Column":
        index = r.read_u32()
        tag = r.read_u8()
        if tag == 255:
            return cls(FIXED, index)
        if tag == 254:
            return cls(INSTANCE, index)
        if tag <= 2:
            return cls(ADVICE, index, tag)
        raise ValueError("Invalid phase for advice column")
