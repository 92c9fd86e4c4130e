"""Limb-minor Montgomery field arithmetic for BN254 Fq and Fr.

Port of halo2_verifier_tpu/ops/field_jax.py. An element is a (..., 16)
tensor of 16-bit limbs, limb axis last, with any number of leading batch
axes that broadcast between operands; int32 at every public boundary (the
port's storage type), Montgomery radix R = 2^256. The constants are
ops/field.py's FQ and FR FieldSpecs.

Two parts, as for every kernel of this package:
- the plain versions are the reference's functions step for step on int64
  tensors: `_carry_reduce` (field_jax.py:65), `_mul_columns` (:80), `_geq`
  (:106), `_sub_limbs` (:119), `_cond_sub_modulus` (:130), `add` (:136),
  `sub` (:142), `neg` (:149), `is_zero` (:155), `eq` (:159), `mont_mul`
  (:163), `to_mont` (:190), `from_mont` (:194), `mont_one` (:199),
  `mont_square` (:203), `select` (:207), `inv_mont` (:212) and `pow_fixed`
  (:229). int64 because torch on the CPU has no uint32 add, sub or shift;
  every value the reference keeps in a uint32 lane fits, and where its
  subtract wraps (bit 31 is the borrow) the int64 value is negative with
  the same low 16 bits and bit 31 set. They run for CPU tensors, and on
  the card only where a caller passes plain=True, as a yardstick;
- for CUDA tensors `mont_mul` (and `to_mont`, `from_mont`, `mont_square`
  and `pow_fixed` on it) launches K1 (csrc/mont_mul.cu) and `inv_mont` T3
  (csrc/tower.cu) on the limbs-major (16, B) layout those kernels take:
  `to_major` broadcasts the operands, flattens their batch axes and
  transposes them to contiguous (16, B) copies, `to_minor` transposes a
  result back. Both are real copies (chip_smoke.py times them apart from
  the kernels). `add`, `sub` and `neg` are plain elementwise torch on
  either device, as ops/field.py's are (in the reference they are XLA, not
  Pallas).

On canonical inputs (below N) every function returns the canonical
result, so the kernels equal the plain versions bit for bit.
"""

from __future__ import annotations

import torch

from . import kernels
from .field import FQ, FR, I32, I64, FieldSpec, pow_bits_body  # noqa: F401
from .limbs import LIMB_BITS, MASK, NLIMBS


def _row(spec: FieldSpec, name: str, device) -> torch.Tensor:
    """(16,) int64 constant limbs of `spec` ('n', 'ninv', 'r', 'r2')."""
    return spec.col(name, device).view(NLIMBS)


# ------------------------------------------------------------ layout adapter

def to_major(*xs):
    """Broadcast (..., 16) limb tensors to one shape and copy each into a
    contiguous limbs-major (16, B) tensor, B the product of the batch
    axes. Returns (batch shape, [(16, B) tensors])."""
    xs = torch.broadcast_tensors(*xs)
    return xs[0].shape[:-1], [
        x.movedim(-1, 0).reshape(NLIMBS, -1).contiguous() for x in xs]


def to_minor(y, shape) -> torch.Tensor:
    """A (16, B) limbs-major tensor as a contiguous (*shape, 16) copy."""
    return y.t().contiguous().view(*shape, NLIMBS)


# ------------------------------------------------------------ plain bodies
# int64 limb tensors in and out, the limb axis last.

def _carry_reduce(cols, out_limbs: int):
    """Carries through the columns -> (..., out_limbs) 16-bit limbs and the
    final carry."""
    limbs = []
    carry = torch.zeros_like(cols[..., 0])
    for k in range(out_limbs):
        c = cols[..., k] + carry
        limbs.append(c & MASK)
        carry = c >> LIMB_BITS
    return torch.stack(limbs, dim=-1), carry


def _mul_columns(a, b, num_cols: int):
    """Column sums of the limb product a*b, each product split into its
    16-bit halves: one shifted slice-add of each half per limb of b."""
    L = a.shape[-1]
    a_b = torch.broadcast_to(
        a, torch.broadcast_shapes(a.shape, b.shape[:-1] + (L,)))
    cols = a_b.new_zeros(a_b.shape[:-1] + (num_cols + 1,))
    for j in range(b.shape[-1]):
        prod = a_b * b[..., j:j + 1]
        lo = prod & MASK
        hi = prod >> LIMB_BITS
        nlo = min(L, num_cols - j)
        if nlo > 0:
            cols[..., j:j + nlo] += lo[..., :nlo]
        nhi = min(L, num_cols - j - 1)
        if nhi > 0:
            cols[..., j + 1:j + 1 + nhi] += hi[..., :nhi]
    return cols[..., :num_cols]


def _geq(a, b):
    """a >= b over limb vectors, branchless lexicographic compare."""
    gt = a > b
    lt = a < b
    result = torch.zeros_like(gt[..., 0])
    decided = torch.zeros_like(result)
    for k in range(a.shape[-1] - 1, -1, -1):
        result = result | (~decided & gt[..., k])
        decided = decided | gt[..., k] | lt[..., k]
    return result | ~decided  # equal -> True


def _sub_limbs(a, b):
    """a - b with a borrow chain; returns (diff, borrow out in {0, 1})."""
    limbs = []
    borrow = torch.zeros_like(a[..., 0])
    for k in range(a.shape[-1]):
        d = a[..., k] - b[..., k] - borrow
        limbs.append(d & MASK)
        borrow = (d >> 31) & 1
    return torch.stack(limbs, dim=-1), borrow


def _cond_sub_modulus(x, spec: FieldSpec):
    """x - N if x >= N else x (x < 2N)."""
    diff, borrow = _sub_limbs(x, _row(spec, "n", x.device))
    return torch.where((borrow == 0).unsqueeze(-1), diff, x)


def _add(a, b, spec: FieldSpec):
    s, _ = _carry_reduce(a + b, NLIMBS)
    return _cond_sub_modulus(s, spec)


def _sub(a, b, spec: FieldSpec):
    diff, borrow = _sub_limbs(a, b)
    n_add = (borrow == 1).unsqueeze(-1) * _row(spec, "n", a.device)
    s, _ = _carry_reduce(diff + n_add, NLIMBS)
    return s


def _neg(a, spec: FieldSpec):
    diff, _ = _sub_limbs(_row(spec, "n", a.device).expand(a.shape), a)
    return torch.where(is_zero(a).unsqueeze(-1), a, diff)


def _mont_mul(a, b, spec: FieldSpec):
    """The three convolutions: T = a*b, m = (T mod 2^256) N' mod 2^256,
    (T + m N) / 2^256 < 2N, then one conditional subtract."""
    t, _ = _carry_reduce(_mul_columns(a, b, 2 * NLIMBS), 2 * NLIMBS)
    m, _ = _carry_reduce(
        _mul_columns(t[..., :NLIMBS], _row(spec, "ninv", a.device), NLIMBS),
        NLIMBS)
    total = _mul_columns(m, _row(spec, "n", a.device), 2 * NLIMBS) + t
    # the low 256 bits of T + mN are zero; only their carry survives
    _, carry = _carry_reduce(total[..., :NLIMBS], NLIMBS)
    hi_cols = torch.cat([(total[..., NLIMBS] + carry).unsqueeze(-1),
                         total[..., NLIMBS + 1:]], dim=-1)
    hi, _ = _carry_reduce(hi_cols, NLIMBS)
    return _cond_sub_modulus(hi, spec)


def _pow_bits(a, bits, spec: FieldSpec):
    """a^e for LSB-first exponent bits by the reference's square-and-
    multiply. A zero bit skips the product the reference computes and
    discards, and the square after the last bit is left out: neither
    changes the output."""
    result = _row(spec, "r", a.device).expand(a.shape)
    base = a
    for i, bit in enumerate(bits):
        if bit:
            result = _mont_mul(result, base, spec)
        if i + 1 < len(bits):
            base = _mont_mul(base, base, spec)
    return result


def _plain(body, *xs, spec):
    return body(*(x.to(I64) for x in xs), spec).to(I32)


# ---------------------------------------------------------- public functions
# int32 (..., 16) limbs in and out.

def add(a, b, spec: FieldSpec):
    return _plain(_add, a, b, spec=spec)


def sub(a, b, spec: FieldSpec):
    return _plain(_sub, a, b, spec=spec)


def neg(a, spec: FieldSpec):
    """-a mod N (0 -> 0)."""
    return _plain(_neg, a, spec=spec)


def is_zero(a):
    return (a == 0).all(dim=-1)


def eq(a, b):
    return (a == b).all(dim=-1)


def select(cond, a, b):
    """cond ? a : b with cond shaped like the batch (no limb axis)."""
    return torch.where(cond.unsqueeze(-1), a, b)


def mont_one(spec: FieldSpec, shape, device) -> torch.Tensor:
    return _row(spec, "r", device).to(I32).expand(
        *shape, NLIMBS).contiguous()


def mont_mul(a, b, spec: FieldSpec, plain: bool = False):
    """Montgomery product ab * 2^-256 mod N of canonical limbs. CUDA
    tensors: one K1 launch on the broadcast operands (raises if it cannot
    run) unless plain=True; CPU tensors: the plain version."""
    if a.is_cuda and not plain:
        shape, (x, y) = to_major(a, b)
        return to_minor(kernels.mont_mul(x, y, spec.kernel_id), shape)
    return _plain(_mont_mul, a, b, spec=spec)


def to_mont(a, spec: FieldSpec, plain: bool = False):
    r2 = _row(spec, "r2", a.device).to(a.dtype)
    return mont_mul(a, r2.expand(a.shape), spec, plain)


def from_mont(a, spec: FieldSpec, plain: bool = False):
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return mont_mul(a, one, spec, plain)


def mont_square(a, spec: FieldSpec, plain: bool = False):
    return mont_mul(a, a, spec, plain)


def inv_mont(a, spec: FieldSpec, plain: bool = False):
    """Fermat inversion a^(N-2) in Montgomery form, inv(0) = 0. CUDA
    tensors: one T3 launch (raises if it cannot run) unless plain=True;
    CPU tensors: the plain version."""
    if a.is_cuda and not plain:
        shape, (x,) = to_major(a)
        return to_minor(kernels.fq_inv(x, spec.kernel_id), shape)
    a = a.to(I64)
    inv = _pow_bits(a, spec.inv_exp_bits, spec)
    return torch.where(is_zero(a).unsqueeze(-1), a, inv).to(I32)


def pow_fixed(a, exponent: int, spec: FieldSpec, plain: bool = False):
    """a^e for a static exponent by square-and-multiply. CUDA tensors: one
    K1 launch per product, in the limbs-major layout (one transpose each
    way) unless plain=True; CPU tensors: the plain version."""
    bits = [(exponent >> i) & 1
            for i in range(max(exponent.bit_length(), 1))]
    if a.is_cuda and not plain:
        shape, (x,) = to_major(a)
        y = pow_bits_body(
            x, bits, spec,
            mul=lambda u, v: kernels.mont_mul(u, v, spec.kernel_id))
        return to_minor(y, shape)
    return _pow_bits(a.to(I64), bits, spec).to(I32)
