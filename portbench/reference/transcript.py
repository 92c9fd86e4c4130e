"""Frozen copy of halo2_verifier_tpu/transcript/__init__.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Fiat-Shamir transcripts (reference: halo2_verifier/src/transcript/mod.rs).

Challenge derivation is inherently sequential hashing, so it lives on the
host; it is per-proof and therefore batch-parallel across proofs. Transcript
replay extracts every commitment/eval/challenge of a proof up front, which is
what lets the device pipeline run entirely out of pre-extracted arrays.

Both reader (verifier) and writer (prover/fixture-generation) halves are
provided, as in the reference (transcript/mod.rs:104-438).
"""

from __future__ import annotations

import hashlib

from . import hostcurve as hc
from . import hostfield as hf
from .keccak import Keccak256

# Domain-separation prefixes (transcript/mod.rs:15-39)
PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"
KECCAK_PREFIX_CHALLENGE_LO = b"\x0a"
KECCAK_PREFIX_CHALLENGE_HI = b"\x0b"


def challenge255(digest64: bytes) -> int:
    """Challenge255::new: squeeze 64 uniform bytes into an Fr scalar
    (transcript/mod.rs:494-509)."""
    return hf.fr_from_uniform_bytes(digest64)


class _Blake2bCore:
    def __init__(self):
        self._state = hashlib.blake2b(
            digest_size=64, person=b"Halo2-Transcript"
        )

    def common_point(self, point) -> None:
        # Points at infinity cannot be absorbed (transcript/mod.rs:216-224)
        if point is None:
            raise ValueError("cannot write points at infinity to the transcript")
        self._state.update(PREFIX_POINT)
        self._state.update(hf.to_repr(point[0]))
        self._state.update(hf.to_repr(point[1]))

    def common_scalar(self, scalar: int) -> None:
        self._state.update(PREFIX_SCALAR)
        self._state.update(hf.to_repr(scalar))

    def squeeze_challenge(self) -> int:
        # squeeze = absorb prefix, clone state, finalize (transcript/mod.rs:209-214)
        self._state.update(PREFIX_CHALLENGE)
        return challenge255(self._state.copy().digest())


class _KeccakCore:
    def __init__(self):
        self._state = Keccak256()
        self._state.update(b"Halo2-Transcript")

    def common_point(self, point) -> None:
        if point is None:
            raise ValueError("cannot write points at infinity to the transcript")
        self._state.update(PREFIX_POINT)
        self._state.update(hf.to_repr(point[0]))
        self._state.update(hf.to_repr(point[1]))

    def common_scalar(self, scalar: int) -> None:
        self._state.update(PREFIX_SCALAR)
        self._state.update(hf.to_repr(scalar))

    def squeeze_challenge(self) -> int:
        # lo||hi dual-finalize construction (transcript/mod.rs:239-254)
        self._state.update(PREFIX_CHALLENGE)
        lo = self._state.copy().update(KECCAK_PREFIX_CHALLENGE_LO).digest()
        hi = self._state.copy().update(KECCAK_PREFIX_CHALLENGE_HI).digest()
        return challenge255(lo + hi)


class _ReadMixin:
    """TranscriptRead: read_point/read_scalar absorb what they read
    (transcript/mod.rs:158-177)."""

    def __init__(self, proof: bytes):
        self._buf = proof
        self._pos = 0

    def _read_exact(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise EOFError("unexpected end of proof stream")
        out = self._buf[self._pos: self._pos + n]
        self._pos += n
        return out

    def read_point(self):
        pt = hc.g1_from_bytes(self._read_exact(32))
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        s = hf.from_repr(self._read_exact(32), hf.R)
        self.common_scalar(s)
        return s

    def read_n_points(self, n: int):
        return [self.read_point() for _ in range(n)]

    def read_n_scalars(self, n: int):
        return [self.read_scalar() for _ in range(n)]


class _WriteMixin:
    """TranscriptWrite: write_point/write_scalar absorb then append
    (transcript/mod.rs:336-368)."""

    def __init__(self):
        self._out = bytearray()

    def write_point(self, pt) -> None:
        self.common_point(pt)
        self._out += hc.g1_to_bytes(pt)

    def write_scalar(self, s: int) -> None:
        self.common_scalar(s)
        self._out += hf.to_repr(s)

    def finalize(self) -> bytes:
        return bytes(self._out)


class Blake2bRead(_Blake2bCore, _ReadMixin):
    def __init__(self, proof: bytes):
        _Blake2bCore.__init__(self)
        _ReadMixin.__init__(self, proof)


class Blake2bWrite(_Blake2bCore, _WriteMixin):
    def __init__(self):
        _Blake2bCore.__init__(self)
        _WriteMixin.__init__(self)


class Keccak256Read(_KeccakCore, _ReadMixin):
    def __init__(self, proof: bytes):
        _KeccakCore.__init__(self)
        _ReadMixin.__init__(self, proof)


class Keccak256Write(_KeccakCore, _WriteMixin):
    def __init__(self):
        _KeccakCore.__init__(self)
        _WriteMixin.__init__(self)


TRANSCRIPT_READERS = {"blake2b": Blake2bRead, "keccak256": Keccak256Read}
TRANSCRIPT_WRITERS = {"blake2b": Blake2bWrite, "keccak256": Keccak256Write}
