"""Frozen copy of halo2_verifier_tpu/ops/hostfield.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Exact host-side field arithmetic for BN254 (Python ints).

This is the framework's correctness oracle and the host orchestration path.
Field elements are plain ints in [0, modulus); extension-field elements are
tuples of ints. The byte formats mirror the reference's halo2curves backend:

- canonical ("repr") form: 32 little-endian bytes of the standard value
  (helpers.rs:74-99 `Processed`)
- raw ("Montgomery") form: 32 little-endian bytes of a*2^256 mod m
  (helpers.rs:82-97 `RawBytes`/`RawBytesUnchecked`)
"""

from __future__ import annotations

from .constants import (
    MONT_R_FQ,
    MONT_R_FR,
    MONT_R_INV_FQ,
    MONT_R_INV_FR,
    P,
    R,
)


# ---------------------------------------------------------------- prime field

def inv(a: int, m: int) -> int:
    if a % m == 0:
        raise ZeroDivisionError("field inversion of zero")
    return pow(a, -1, m)


def batch_invert(values: list[int], m: int) -> list[int]:
    """Montgomery's trick; mirrors ff's BatchInvert used at domain.rs:115-122.

    Zero entries are passed through unchanged (ff's batch_invert skips them).
    """
    prods: list[int] = []
    acc = 1
    for v in values:
        prods.append(acc)
        if v != 0:
            acc = acc * v % m
    acc = inv(acc, m)
    out = list(values)
    for i in range(len(values) - 1, -1, -1):
        if values[i] != 0:
            out[i] = acc * prods[i] % m
            acc = acc * values[i] % m
    return out


def fr_from_uniform_bytes(b: bytes) -> int:
    """ff::FromUniformBytes<64> for bn256 Fr: int_le(bytes) mod r.

    Used by Challenge255::new (transcript/mod.rs:494-509).
    """
    assert len(b) == 64
    return int.from_bytes(b, "little") % R


def to_repr(a: int) -> bytes:
    """Canonical little-endian 32-byte form (PrimeField::to_repr)."""
    return int(a).to_bytes(32, "little")


def from_repr(b: bytes, m: int) -> int:
    """PrimeField::from_repr: rejects values >= modulus (returns None)."""
    v = int.from_bytes(b, "little")
    if v >= m:
        raise ValueError("field repr not canonical (>= modulus)")
    return v


def try_from_repr(b: bytes, m: int) -> int | None:
    v = int.from_bytes(b, "little")
    return v if v < m else None


def fq_to_raw(a: int) -> bytes:
    return (a * MONT_R_FQ % P).to_bytes(32, "little")


def fq_from_raw(b: bytes, check: bool = True) -> int:
    v = int.from_bytes(b, "little")
    if check and v >= P:
        raise ValueError("raw Fq not canonical")
    return v * MONT_R_INV_FQ % P


def fr_to_raw(a: int) -> bytes:
    return (a * MONT_R_FR % R).to_bytes(32, "little")


def fr_from_raw(b: bytes, check: bool = True) -> int:
    v = int.from_bytes(b, "little")
    if check and v >= R:
        raise ValueError("raw Fr not canonical")
    return v * MONT_R_INV_FR % R


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (p = 3 mod 4): a^((p+1)/4); None if non-residue."""
    r = pow(a, (P + 1) >> 2, P)
    return r if r * r % P == a % P else None


# ------------------------------------------------------------------- Fq2
# Fq2 = Fq[u]/(u^2+1); elements are (c0, c1).

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def fq2_square(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def fq2_mul_scalar(a, s: int):
    return (a[0] * s % P, a[1] * s % P)


def fq2_conj(a):
    return (a[0], -a[1] % P)


def fq2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = inv(norm, P)
    return (a[0] * ninv % P, -a[1] * ninv % P)


def fq2_sqrt(a):
    """Square root in Fq2 (p = 3 mod 4), standard complex-method algorithm."""
    if a == FQ2_ZERO:
        return FQ2_ZERO
    # try sqrt of the norm
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    n = fq_sqrt(norm)
    if n is None:
        return None
    for sign in (1, -1):
        t = (a[0] + sign * n) * pow(2, -1, P) % P
        c0 = fq_sqrt(t)
        if c0 is None:
            continue
        if c0 == 0:
            c1 = fq_sqrt(-a[0] % P) if a[1] == 0 else None
            if a[1] == 0 and c1 is not None:
                return (0, c1)
            continue
        c1 = a[1] * pow(2 * c0, -1, P) % P
        cand = (c0, c1)
        if fq2_square(cand) == (a[0] % P, a[1] % P):
            return cand
    return None


def fq2_is_odd(a) -> bool:
    """Sign convention used by halo2curves point compression: LSB of c0."""
    return bool(a[0] & 1)


def fq2_to_repr(a) -> bytes:
    return to_repr(a[0]) + to_repr(a[1])


def fq2_from_repr(b: bytes):
    return (from_repr(b[:32], P), from_repr(b[32:], P))


def fq2_to_raw(a) -> bytes:
    return fq_to_raw(a[0]) + fq_to_raw(a[1])


def fq2_from_raw(b: bytes, check: bool = True):
    return (fq_from_raw(b[:32], check), fq_from_raw(b[32:], check))
