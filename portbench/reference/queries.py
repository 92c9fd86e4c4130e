"""Frozen copy of halo2_verifier_tpu/protocol/queries.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Verifier opening queries (reference: poly/query.rs).

The reference distinguishes commitments by *pointer* equality
(query.rs:63-74) so that the same column queried at several rotations groups
into one rotation set. Here every distinct commitment source carries an
explicit hashable key with the same semantics (deterministic, and usable as
a device-side gather index when batching).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class VerifierQuery:
    point: int          # evaluation point (Fr)
    eval: int           # claimed evaluation (Fr)
    commit_key: Any     # hashable identity (pointer-equality analogue)
    commitment: Any     # G1 affine point, or MSMKZG for the h(X) query
    is_msm: bool = False

    @classmethod
    def from_commitment(cls, key, commitment, point, ev):
        return cls(point, ev, key, commitment, False)

    @classmethod
    def from_msm(cls, key, msm, point, ev):
        return cls(point, ev, key, msm, True)
