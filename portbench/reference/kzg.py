"""Frozen copy of halo2_verifier_tpu/protocol/kzg.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

KZG commitment scheme: verifier params, MSM accumulators, strategies.

Reference: poly/kzg/{commitment.rs,msm.rs,strategy.rs}. The space-efficient
verifier params hold only {k, n, g, g2, s_g2} (commitment.rs:22-29).

The MSM accumulators here collect (scalar, point) terms symbolically; the
final evaluation is dispatched either to the exact host MSM or to the
batched TPU Pippenger kernel (ops/msm_jax.py). That split — symbolic
accumulation on host, arithmetic on device — is the TPU-native shape of
DualMSM: for a batch of proofs the per-proof accumulators concatenate into
one big device MSM with a single pairing.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field

from . import hostcurve as hc
from . import hostpairing as hp
from .constants import R
from .serde import ByteReader, ByteWriter
from .vk import PROCESSED, RAW_BYTES


@dataclass
class ParamsKZG:
    k: int
    n: int
    g: tuple  # G1 affine
    g2: tuple  # G2 affine
    s_g2: tuple  # G2 affine

    # codec (poly/kzg/commitment.rs:142-207): k is LITTLE-endian u32 here.
    def write(self, w: ByteWriter, fmt: str = PROCESSED) -> None:
        w.write_all(int(self.k).to_bytes(4, "little"))
        if fmt == PROCESSED:
            w.write_all(hc.g1_to_bytes(self.g))
            w.write_all(hc.g2_to_bytes(self.g2))
            w.write_all(hc.g2_to_bytes(self.s_g2))
        else:
            w.write_all(hc.g1_to_raw(self.g))
            w.write_all(hc.g2_to_raw(self.g2))
            w.write_all(hc.g2_to_raw(self.s_g2))

    @classmethod
    def read(cls, r: ByteReader, fmt: str = PROCESSED) -> "ParamsKZG":
        k = int.from_bytes(r.read_exact(4), "little")
        if fmt == PROCESSED:
            g = hc.g1_from_bytes(r.read_exact(32))
            g2 = hc.g2_from_bytes(r.read_exact(64))
            s_g2 = hc.g2_from_bytes(r.read_exact(64))
        else:
            check = fmt == RAW_BYTES
            g = hc.g1_from_raw(r.read_exact(64), check)
            g2 = hc.g2_from_raw(r.read_exact(128), check)
            s_g2 = hc.g2_from_raw(r.read_exact(128), check)
        return cls(k, 1 << k, g, g2, s_g2)

    def to_bytes(self, fmt: str = PROCESSED) -> bytes:
        w = ByteWriter()
        self.write(w, fmt)
        return w.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, fmt: str = PROCESSED) -> "ParamsKZG":
        return cls.read(ByteReader(data), fmt)


@dataclass
class MSMKZG:
    """A growable multi-scalar multiplication (poly/kzg/msm.rs:17-95)."""

    scalars: list = field(default_factory=list)
    bases: list = field(default_factory=list)  # affine points (host repr)

    def append_term(self, scalar: int, point) -> None:
        self.scalars.append(scalar % R)
        self.bases.append(point)

    def add_msm(self, other: "MSMKZG") -> None:
        self.scalars.extend(other.scalars)
        self.bases.extend(other.bases)

    def scale(self, factor: int) -> None:
        factor %= R
        self.scalars = [s * factor % R for s in self.scalars]

    def combine_with_base(self, base: int) -> None:
        """Horner-weight the scalars: scalars[i] *= base^(len-1-i)
        (poly/kzg/msm.rs:40-49)."""
        acc = 1
        for i in range(len(self.scalars) - 1, -1, -1):
            self.scalars[i] = self.scalars[i] * acc % R
            acc = acc * base % R

    def clone(self) -> "MSMKZG":
        return MSMKZG(list(self.scalars), list(self.bases))

    def eval(self):
        return hc.g1_msm(self.scalars, self.bases)

    def check(self) -> bool:
        return self.eval() is None


@dataclass
class DualMSM:
    """Two-channel accumulator whose check() is the final pairing test
    e(left, s_g2) * e(right, -g2) == 1 (poly/kzg/msm.rs:148-203)."""

    params: ParamsKZG
    left: MSMKZG = field(default_factory=MSMKZG)
    right: MSMKZG = field(default_factory=MSMKZG)

    def scale(self, e: int) -> None:
        self.left.scale(e)
        self.right.scale(e)

    def add_msm(self, other: "DualMSM") -> None:
        self.left.add_msm(other.left)
        self.right.add_msm(other.right)

    def check(self, msm_eval=None, pairing=None) -> bool:
        if msm_eval is None:
            msm_eval = lambda m: m.eval()
        left = msm_eval(self.left)
        right = msm_eval(self.right)
        return (pairing or hp.pairing_check)(
            [(left, self.params.s_g2), (right, hc.g2_neg(self.params.g2))]
        )


def pairing_backend(name: str = "host"):
    """The final pairing: the plain Python multi-Miller loop and final
    exponentiation (hostpairing.pairing_check)."""
    if name in ("host", None):
        return hp.pairing_check
    raise ValueError(f"unknown pairing backend {name!r} (expected 'host')")


class SingleStrategy:
    """Verify one proof, pairing immediately (kzg/strategy.rs:83-181)."""

    def __init__(self, params: ParamsKZG, pairing: str = "host"):
        self.params = params
        self._pairing = pairing_backend(pairing)

    def process(self, f) -> None:
        guard = GuardKZG(f(DualMSM(self.params)))
        if not guard.verify(pairing=self._pairing):
            raise ConstraintSystemFailure(
                "constraint system failure (kzg/strategy.rs:164-177)"
            )

    def finalize(self) -> bool:  # pragma: no cover - parity only
        raise RuntimeError("SingleStrategy has no finalize")


class AccumulatorStrategy:
    """Batch verifier: random-scale the accumulator before each proof and
    defer a single pairing to finalize() (kzg/strategy.rs:55-141)."""

    def __init__(self, params: ParamsKZG, rng=None):
        self.params = params
        self.msm_accumulator = DualMSM(params)
        self._rng = rng or (lambda: secrets.randbelow(R))

    def process(self, f) -> "AccumulatorStrategy":
        self.msm_accumulator.scale(self._rng())
        self.msm_accumulator = f(self.msm_accumulator)
        return self

    def finalize(self) -> bool:
        return self.msm_accumulator.check()


@dataclass
class Blind:
    """Commitment blinding factor wrapper (poly/commitment.rs:121-174).
    The verifier never blinds, but the type completes the commitment-
    scheme API surface (used by the test prover)."""

    value: int = 1

    def __add__(self, other):
        return Blind((self.value + _blind_val(other)) % R)

    def __mul__(self, other):
        return Blind(self.value * _blind_val(other) % R)

    __radd__ = __add__
    __rmul__ = __mul__


def _blind_val(x):
    return x.value if isinstance(x, Blind) else x % R


class GuardKZG:
    """An unfinished verification: wraps the DualMSM whose pairing check
    certifies the proof (kzg/strategy.rs:23-51). `use_challenges` yields
    the accumulator for deferred batching; `verify` runs the pairing now."""

    def __init__(self, msm_accumulator: DualMSM):
        self.msm_accumulator = msm_accumulator

    def use_challenges(self) -> DualMSM:
        return self.msm_accumulator

    def verify(self, msm_eval=None, pairing=None) -> bool:
        return self.msm_accumulator.check(msm_eval, pairing=pairing)


class VerifyFailure(Exception):
    """Raised when a proof does not verify (plonk/mod.rs Error base)."""


class ConstraintSystemFailure(VerifyFailure):
    """The pairing/constraint check failed (Error::ConstraintSystemFailure,
    plonk/mod.rs:19-32)."""


class OpeningError(VerifyFailure):
    """Multiopen argument malformed (Error::Opening)."""


class TranscriptError(VerifyFailure):
    """Proof stream malformed: bad point/scalar encoding or truncation
    (Error::Transcript)."""


class BoundsFailure(VerifyFailure):
    """An index exceeded the circuit's bounds (Error::BoundsFailure)."""


class InstanceTooLarge(VerifyFailure):
    """Instance column longer than the usable row count
    (Error::InstanceTooLarge)."""
