"""float32 8-bit-limb Montgomery field arithmetic for BN254 Fq and Fr.

Port of halo2_verifier_tpu/ops/lmfield8.py, the reference's second limb
format: a batch of field elements is a (NLIMBS8=32, B) float32 tensor,
limbs-major, least-significant limb first. Canonical limbs are integers in
[0, 255]; float32 arithmetic on integers is exact up to 2^24, and every
intermediate below stays under it (the bounds are stated inline, as in the
reference). Montgomery R stays 2^256, so a value in Montgomery form is the
same residue as in the 16-bit format (ops/field.py) and switching formats
is pure re-limbing (`expand16_to8`, and weights.limbs16_to_limbs8 on the
host).

Two parts, as for every kernel of this package:
- the `*_body` functions are plain torch on float32 tensors, written as
  the reference writes them (shift-fold carries, a Kogge-Stone completion,
  three 8-bit convolutions), so the format itself is what the CPU tests
  hold against the reference;
- `mont_mul` launches the Hopper kernel (csrc/mont_mul8.cu) for CUDA
  tensors and uses the body for CPU tensors. The kernel packs the limbs
  into 32-bit words and multiplies integers; on canonical limbs it equals
  the body limb for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .field import FieldSpec

F32 = torch.float32
NLIMBS8 = 32
LIMB_BITS8 = 8
BASE = 256.0
INV_BASE = 1.0 / 256.0
MASK8 = 255


def int_to_limbs8(v: int) -> np.ndarray:
    out = np.zeros(NLIMBS8, dtype=np.float32)
    for i in range(NLIMBS8):
        out[i] = float((v >> (8 * i)) & 0xFF)
    return out


def limbs8_to_int(col) -> int:
    v = 0
    for i in range(NLIMBS8 - 1, -1, -1):
        v = (v << 8) + int(round(float(col[i])))
    return v


def _bytes_of(v: int):
    return [(v >> (8 * i)) & 0xFF for i in range(NLIMBS8)]


_SPEC_INTS8: dict = {}
_COLS: dict = {}


def _spec_ints8(spec: FieldSpec):
    """(N limbs, 255 - N limbs, N' limbs, R limbs) as 8-bit Python ints."""
    ints = _SPEC_INTS8.get(spec.kernel_id)
    if ints is None:
        nl = _bytes_of(spec.modulus)
        ints = (nl, [255 - v for v in nl], _bytes_of(spec.ninv),
                _bytes_of(spec.mont_r))
        _SPEC_INTS8[spec.kernel_id] = ints
    return ints


def col(spec: FieldSpec, name: str, device) -> torch.Tensor:
    """(NLIMBS8, 1) float32 constant column on `device`, cached: 'n',
    'comp1' (255 - N per limb, plus one at row 0), 'r' (Montgomery one) or
    'r2' (R^2 mod N)."""
    key = (spec.kernel_id, name, str(device))
    c = _COLS.get(key)
    if c is None:
        nl, comp, _nv, r_mont = _spec_ints8(spec)
        vals = {
            "n": nl,
            "comp1": [v + (k == 0) for k, v in enumerate(comp)],
            "r": r_mont,
            "r2": _bytes_of(spec.mont_r2),
        }[name]
        c = torch.tensor(vals, dtype=F32, device=device).reshape(NLIMBS8, 1)
        _COLS[key] = c
    return c


# ------------------------------------------------------------ plain bodies

def _shift_rows_down(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _hi(x):
    """floor(x / 256), exact: x is an integer <= 2^24 and 1/256 is a power
    of two, so the product and the floor round nothing."""
    return torch.floor(x * INV_BASE)


def carry_fold(x, passes: int):
    """Shift-fold passes: integer columns <= 2^24 -> limbs <= 256 after 3
    passes (2^24 -> 255+2^16 -> 255+2^8 -> 255+1). Limbs <= 256 are safe
    convolution inputs (256 * 255 * 32 < 2^22 < 2^24)."""
    for _ in range(passes):
        h = _hi(x)
        x = (x - h * BASE) + _shift_rows_down(h)
    return x


def carry_full(x):
    """Fully canonical limbs (< 256): 3 folds, then a Kogge-Stone
    generate/propagate completion for the residual 256-valued rows. Input
    columns <= 2^24; carries out of the top row are dropped."""
    x = carry_fold(x, 3)
    # x <= 256: value = r + 256*g, g in {0, 1}
    g = _hi(x)
    r = x - g * BASE
    G = _shift_rows_down(g)
    P = _shift_rows_down((r == MASK8).to(F32))
    rows = x.shape[0]
    d = 1
    while d < rows:
        zG = torch.cat([torch.zeros_like(G[:d]), G[:-d]])
        zP = torch.cat([torch.zeros_like(P[:d]), P[:-d]])
        G = torch.maximum(G, P * zG)
        P = P * zP
        d *= 2
    # out_k = (r_k + c_k) mod 256: a row hitting 256 has passed its carry
    # on through the propagate chain already, so mask without propagating
    x = r + G
    return x - _hi(x) * BASE


def _with_overflow_row(x):
    return torch.cat([x, torch.zeros_like(x[:1])])


def cond_sub_n(x, spec: FieldSpec):
    """x - N if x >= N else x, for canonical-limbed x < 2N."""
    t = carry_full(_with_overflow_row(x + col(spec, "comp1", x.device)))
    return torch.where(t[NLIMBS8:] > 0, t[:NLIMBS8], x)


def add_body(a, b, spec: FieldSpec):
    return cond_sub_n(carry_full(a + b), spec)


def sub_body(a, b, spec: FieldSpec):
    # a - b + 2^256 via complement add; the overflow row is "no borrow"
    t = a + (float(MASK8) - b)
    t = torch.cat([t[:1] + 1.0, t[1:]])
    t = carry_full(_with_overflow_row(t))
    borrow = (t[NLIMBS8:] == 0).to(F32)
    return carry_full(t[:NLIMBS8] + borrow * col(spec, "n", a.device))


def neg_body(a, spec: FieldSpec):
    return sub_body(torch.zeros_like(a), a, spec)


def is_zero(a):
    return (a == 0).all(dim=0)


def select(cond, a, b):
    """cond ? a : b with cond shaped like the lane axes."""
    return torch.where(cond.unsqueeze(0), a, b)


def mont_one(spec: FieldSpec, b: int, device):
    return col(spec, "r", device).expand(NLIMBS8, b).contiguous()


def mont_mul_body(a, b, spec: FieldSpec):
    """Montgomery product a*b*2^-256 mod N on (NLIMBS8, B) canonical limbs.

    Three 8-bit convolutions, all products and column sums exact in f32:
    - T = a*b: 64 columns, each <= 32 * 255 * 256 < 2^21.
    - m = (T mod 2^256) * N' mod 2^256: low 32 columns only; T's limbs are
      2-pass folded (<= 255 + 2^8 <= 512; 512 * 255 * 32 < 2^22).
    - T + m*N: the low half is divisible by 2^256; folded with TWO overflow
      rows (its raw value reaches ~2^270), the 32 low rows then hold
      exactly 0 or 2^256, so the carry into the high half is overflow +
      any-nonzero. The high half fully normalizes and cond-subtracts.
    """
    nl, _, nv, _ = _spec_ints8(spec)
    k2 = 2 * NLIMBS8
    shape = (k2,) + tuple(a.shape[1:])

    cols = torch.zeros(shape, dtype=F32, device=a.device)
    for j in range(NLIMBS8):
        cols[j:j + NLIMBS8] += a * b[j]
    t = carry_fold(cols, 2)  # limbs <= 255 + 2^8

    tl = t[:NLIMBS8]
    mcols = torch.zeros_like(tl)
    for j in range(NLIMBS8):
        if nv[j] == 0:
            continue
        mcols[j:] += tl[:NLIMBS8 - j] * float(nv[j])
    # m must be canonical (< 2^256 as a VALUE) for the REDC bound hi < 2N;
    # carry_full's top-row carry drops are exactly the mod 2^256
    m = carry_full(mcols)

    total = t.clone()  # columns <= 32*512*255 + 512 < 2^23
    for j in range(NLIMBS8):
        if nl[j] == 0:
            continue
        total[j:j + NLIMBS8] += m * float(nl[j])

    low = carry_fold(
        torch.cat([total[:NLIMBS8], torch.zeros_like(total[:2])]), 3)
    low_any = (low[:NLIMBS8] != 0).any(dim=0).to(F32)
    carry = low[NLIMBS8] + low[NLIMBS8 + 1] * BASE + low_any
    hi = total[NLIMBS8:].clone()
    hi[0] += carry
    return cond_sub_n(carry_full(hi), spec)


def mont_mul(a, b, spec: FieldSpec):
    """Montgomery multiply of (NLIMBS8, B) float32 tensors of canonical
    limbs. CUDA tensors go to the Hopper kernel (which raises if it cannot
    run); CPU tensors to the plain body."""
    if a.is_cuda:
        return kernels.mont_mul8(a, b, spec.kernel_id)
    return mont_mul_body(a, b, spec)


def expand16_to8(x):
    """(16, B) int32 16-bit limbs -> (32, B) float32 8-bit limbs."""
    lo = (x & 0xFF).to(F32)
    hi = ((x >> 8) & 0xFF).to(F32)
    return torch.stack([lo, hi], dim=1).reshape(2 * x.shape[0], *x.shape[1:])
