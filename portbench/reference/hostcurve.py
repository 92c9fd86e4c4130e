"""Frozen copy of halo2_verifier_tpu/ops/hostcurve.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Exact host-side BN254 G1/G2 group arithmetic and point codecs.

Points are represented as:
- affine: (x, y) tuples, or ``None`` for the identity;
- G2 affine coordinates are Fq2 pairs ((x0,x1),(y0,y1)).

Byte formats mirror the halo2curves backend the reference builds on:
- compressed (``Processed``): 32 B (G1) / 64 B (G2) little-endian x with the
  y-parity sign flag in bit 7 of the last byte; identity is all-zeroes.
- raw (``RawBytes``): uncompressed x||y with each coordinate in Montgomery
  little-endian form (64 B G1 / 128 B G2); identity is all-zeroes.
Reference consumers: transcript point reads (transcript/mod.rs:158-166) and
vk/params codecs (helpers.rs:33-65).
"""

from __future__ import annotations

from .constants import B_G1, B_G2, P, R
from . import hostfield as hf



# ------------------------------------------------------------------ G1 (Fq)

def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B_G1) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1] % P)


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return g1_double(a)
    lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(a):
    if a is None:
        return None
    x, y = a
    if y == 0:
        return None
    lam = 3 * x * x * pow(2 * y, -1, P) % P
    x3 = (lam * lam - 2 * x) % P
    y3 = (lam * (x - x3) - y) % P
    return (x3, y3)


def g1_mul(pt, k: int):
    k %= R
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_double(add)
        k >>= 1
    return acc


# Jacobian coordinates: (X, Y, Z) with x = X/Z^2, y = Y/Z^3; identity Z=0.

J_IDENTITY = (0, 1, 0)


def j_from_affine(pt):
    return J_IDENTITY if pt is None else (pt[0], pt[1], 1)


def j_to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


def j_double(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return J_IDENTITY
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def j_add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 % P * Z2Z2 % P
    S2 = Y2 * Z1 % P * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return J_IDENTITY
        return j_double(p)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    rr = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
    return (X3, Y3, Z3)


def j_add_affine(p, q):
    """Mixed addition p (Jacobian) + q (affine)."""
    if q is None:
        return p
    X1, Y1, Z1 = p
    if Z1 == 0:
        return (q[0], q[1], 1)
    x2, y2 = q
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1 % P * Z1Z1 % P
    if U2 == X1:
        if S2 != Y1:
            return J_IDENTITY
        return j_double(p)
    H = (U2 - X1) % P
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    rr = 2 * (S2 - Y1) % P
    V = X1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * Y1 * J) % P
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % P
    return (X3, Y3, Z3)


def j_mul(p, k: int):
    k %= R
    acc = J_IDENTITY
    add = p
    while k:
        if k & 1:
            acc = j_add(acc, add)
        add = j_double(add)
        k >>= 1
    return acc


def batch_normalize(points):
    """Jacobian -> affine for many points with one shared inversion chain."""
    from .hostfield import batch_invert

    zs = [p[2] for p in points]
    zinvs = batch_invert(zs, P)
    out = []
    for (X, Y, Z), zi in zip(points, zinvs):
        if Z == 0:
            out.append(None)
        else:
            zi2 = zi * zi % P
            out.append((X * zi2 % P, Y * zi2 % P * zi % P))
    return out


def g1_msm(scalars, points, window: int = None):
    """Host MSM: windowed Pippenger over Jacobian buckets.

    Window sizing follows the small-n heuristic shape of halo2's
    (arithmetic.rs:10-16), tuned for Python's cost model.
    """
    assert len(scalars) == len(points)
    pairs = [(s % R, pt) for s, pt in zip(scalars, points)
             if s % R != 0 and pt is not None]
    if not pairs:
        return None
    if len(pairs) == 1:
        s, pt = pairs[0]
        return j_to_affine(j_mul(j_from_affine(pt), s))
    c = window or (4 if len(pairs) < 32 else (8 if len(pairs) < 1024 else 12))
    num_windows = (254 + c - 1) // c
    acc = J_IDENTITY
    mask = (1 << c) - 1
    for w in range(num_windows - 1, -1, -1):
        for _ in range(c if acc != J_IDENTITY else 0):
            acc = j_double(acc)
        buckets = [None] * ((1 << c) - 1)
        shift = w * c
        for s, pt in pairs:
            digit = (s >> shift) & mask
            if digit:
                b = buckets[digit - 1]
                buckets[digit - 1] = (
                    (pt[0], pt[1], 1) if b is None else j_add_affine(b, pt)
                )
        running = J_IDENTITY
        for b in reversed(buckets):
            if b is not None:
                running = j_add(running, b)
            acc = j_add(acc, running) if running != J_IDENTITY else acc
    return j_to_affine(acc)


# compressed codec -----------------------------------------------------------

def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return bytes(32)
    x, y = pt
    b = bytearray(hf.to_repr(x))
    if y & 1:
        b[31] |= 0x80
    return bytes(b)


def g1_from_bytes(b: bytes):
    """Decompress; raises ValueError on invalid encodings (CurveRead path)."""
    assert len(b) == 32
    arr = bytearray(b)
    ysign = (arr[31] >> 7) & 1
    arr[31] &= 0x7F
    x = hf.from_repr(bytes(arr), P)
    if x == 0 and ysign == 0:
        return None
    y = hf.fq_sqrt((x * x * x + B_G1) % P)
    if y is None:
        raise ValueError("invalid point encoding: x not on curve")
    if (y & 1) != ysign:
        y = -y % P
    return (x, y)


# raw (Montgomery, uncompressed) codec ---------------------------------------

def g1_to_raw(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return hf.fq_to_raw(pt[0]) + hf.fq_to_raw(pt[1])


def g1_from_raw(b: bytes, check: bool = True):
    assert len(b) == 64
    x = hf.fq_from_raw(b[:32], check)
    y = hf.fq_from_raw(b[32:], check)
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if check and not g1_is_on_curve(pt):
        raise ValueError("raw point not on curve")
    return pt


# ------------------------------------------------------------------ G2 (Fq2)

def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = hf.fq2_square(y)
    rhs = hf.fq2_add(hf.fq2_mul(hf.fq2_square(x), x), B_G2)
    return lhs == rhs


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], hf.fq2_neg(pt[1]))


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if hf.fq2_add(y1, y2) == hf.FQ2_ZERO:
            return None
        return g2_double(a)
    lam = hf.fq2_mul(hf.fq2_sub(y2, y1), hf.fq2_inv(hf.fq2_sub(x2, x1)))
    x3 = hf.fq2_sub(hf.fq2_sub(hf.fq2_square(lam), x1), x2)
    y3 = hf.fq2_sub(hf.fq2_mul(lam, hf.fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_double(a):
    if a is None:
        return None
    x, y = a
    if y == hf.FQ2_ZERO:
        return None
    lam = hf.fq2_mul(
        hf.fq2_mul_scalar(hf.fq2_square(x), 3),
        hf.fq2_inv(hf.fq2_mul_scalar(y, 2)),
    )
    x3 = hf.fq2_sub(hf.fq2_square(lam), hf.fq2_mul_scalar(x, 2))
    y3 = hf.fq2_sub(hf.fq2_mul(lam, hf.fq2_sub(x, x3)), y)
    return (x3, y3)


def g2_mul(pt, k: int):
    k %= R
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_double(add)
        k >>= 1
    return acc


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        return bytes(64)
    x, y = pt
    b = bytearray(hf.fq2_to_repr(x))
    if hf.fq2_is_odd(y):
        b[63] |= 0x80
    return bytes(b)


def g2_from_bytes(b: bytes):
    assert len(b) == 64
    arr = bytearray(b)
    ysign = (arr[63] >> 7) & 1
    arr[63] &= 0x7F
    x = hf.fq2_from_repr(bytes(arr))
    if x == hf.FQ2_ZERO and ysign == 0:
        return None
    y2 = hf.fq2_add(hf.fq2_mul(hf.fq2_square(x), x), B_G2)
    y = hf.fq2_sqrt(y2)
    if y is None:
        raise ValueError("invalid G2 point encoding")
    if hf.fq2_is_odd(y) != bool(ysign):
        y = hf.fq2_neg(y)
    return (x, y)


def g2_to_raw(pt) -> bytes:
    if pt is None:
        return bytes(128)
    return hf.fq2_to_raw(pt[0]) + hf.fq2_to_raw(pt[1])


def g2_from_raw(b: bytes, check: bool = True):
    assert len(b) == 128
    x = hf.fq2_from_raw(b[:64], check)
    y = hf.fq2_from_raw(b[64:], check)
    if x == hf.FQ2_ZERO and y == hf.FQ2_ZERO:
        return None
    pt = (x, y)
    if check and not g2_is_on_curve(pt):
        raise ValueError("raw G2 point not on curve")
    return pt
