"""Limbs-major Montgomery field arithmetic for BN254 Fq and Fr.

Port of halo2_verifier_tpu/ops/lmfield.py and of field_jax.FieldSpec.

Layout at every public function boundary is the reference's: a batch of
field elements is a (NLIMBS=16, B) tensor of 16-bit limbs, limb axis
leading, stored in int32; Montgomery radix R = 2^256.

Two parts, as for every kernel of this package:
- the `*_body` functions are plain torch on int64 tensors. They follow the
  reference's uint32 bodies step for step; int64 because torch on the CPU
  has no add, sub or shift for uint32 (and `mont_mul_body` sums whole
  64-bit columns where the reference splits each product in halves). They
  run on the CPU (tests), and on the card only where a caller asks for
  them explicitly as a yardstick;
- `mont_mul` launches the Hopper Montgomery-multiply kernel
  (csrc/mont_mul.cu) for CUDA tensors and uses the body for CPU tensors;
  `inv_mont` likewise the Fermat inversion kernel (csrc/tower.cu).

On canonical inputs (below N) every body returns the canonical result,
as the reference's do, so the kernel (a 32-bit-word CIOS product) equals
the body bit for bit there; every operand on the main path is canonical.
One case is worth knowing: the reference folds m = T * N' mod 2^256 only
twice, and where the fold's top limb comes out exactly 2^16 the folded
limbs stand for m + 2^256. That needs m below 2^241, so the result
(T + mN)/2^256 + N is below 2N and the final conditional subtract still
lands on the canonical value. tests/test_torch_field.py holds three such
inputs against the body here.
"""

from __future__ import annotations

import torch

from . import kernels
from .constants import P, R
from .limbs import LIMB_BITS, MASK, NLIMBS, int_to_limbs

I32 = torch.int32
I64 = torch.int64


class FieldSpec:
    """Per-modulus constants (port of field_jax.FieldSpec): the N limbs,
    N' = -N^{-1} mod 2^256, R, R^2 and the exponent bits, as Python ints.
    `kernel_id` selects the modulus inside the CUDA kernels."""

    def __init__(self, modulus: int, kernel_id: int):
        self.modulus = modulus
        self.kernel_id = kernel_id
        self.mont_r = (1 << 256) % modulus
        self.mont_r2 = self.mont_r * self.mont_r % modulus
        self.ninv = (-pow(modulus, -1, 1 << 256)) % (1 << 256)
        self.n_limbs = [int(v) for v in int_to_limbs(modulus)]
        self.ninv_limbs = [int(v) for v in int_to_limbs(self.ninv)]
        self.r_limbs = [int(v) for v in int_to_limbs(self.mont_r)]
        self.r2_limbs = [int(v) for v in int_to_limbs(self.mont_r2)]
        e = modulus - 2
        self.inv_exp_bits = [(e >> i) & 1 for i in range(256)]
        if modulus % 4 == 3:
            s = (modulus + 1) // 4
            self.sqrt_exp_bits = [(s >> i) & 1 for i in range(256)]
        else:
            self.sqrt_exp_bits = None
        self._cols = {}

    def col(self, name: str, device) -> torch.Tensor:
        """(NLIMBS, 1) int64 constant column ('n', 'comp1', 'r', 'r2') on
        `device`, cached per device."""
        key = (name, str(device))
        c = self._cols.get(key)
        if c is None:
            if name == "comp1":  # 16-bit complement of N, plus one at row 0
                vals = [MASK - v + (k == 0)
                        for k, v in enumerate(self.n_limbs)]
            else:
                vals = getattr(self, f"{name}_limbs")
            c = torch.tensor(vals, dtype=I64, device=device).reshape(
                NLIMBS, 1)
            self._cols[key] = c
        return c


FQ = FieldSpec(P, 0)
FR = FieldSpec(R, 1)


# ------------------------------------------------------------ plain bodies
# All bodies take and return int64 limb tensors (NLIMBS or more rows, B).

def _shift_rows_down(x):
    """Carry shift: row k -> row k+1; row 0 zero-filled, top row dropped."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def carry_fold2(x):
    """Two shift-fold passes: limbs <= 2^16 (not fully canonical), value
    unchanged; carries out of the top row are dropped."""
    for _ in range(2):
        x = (x & MASK) + _shift_rows_down(x >> LIMB_BITS)
    return x


def carry_prop(x):
    """Exact carry propagation to canonical 16-bit limbs (the reference's
    carry_prop_static, bit for bit): two folds bring every row to <= 2^16,
    so each row passes an incoming +1 on (low limb 2^16 - 1) or stops it.
    The carry into row k is then the carry out of the last row below k
    that stops, found by a running maximum of row indices. Carries out of
    the top row are dropped."""
    x = carry_fold2(x)
    r = x & MASK
    rows = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (x.dim() - 1))
    stop = torch.where(r == MASK, -1, rows).cummax(dim=0).values
    below = _shift_rows_down(stop + 1) - 1  # -1: no stopping row below
    carry = (x >> LIMB_BITS).gather(0, below.clamp(min=0)) * (below >= 0)
    return (r + carry) & MASK


def _with_overflow_row(x):
    return torch.cat([x, torch.zeros_like(x[:1])])


def cond_sub_n(x, spec: FieldSpec):
    """x - N if x >= N else x, for carried x (branchless): adds 2^256 - N
    with an explicit overflow row, whose bit is the x >= N predicate."""
    t = carry_prop(_with_overflow_row(x + spec.col("comp1", x.device)))
    return torch.where(t[NLIMBS:] > 0, t[:NLIMBS], x)


def add_body(a, b, spec: FieldSpec):
    return cond_sub_n(carry_prop(a + b), spec)


def sub_body(a, b, spec: FieldSpec):
    # a - b + 2^256 via complement add; the overflow row is "no borrow"
    t = a + (MASK - b)
    t = torch.cat([t[:1] + 1, t[1:]])
    t = carry_prop(_with_overflow_row(t))
    borrow = (t[NLIMBS:] == 0).to(t.dtype)
    return carry_prop(t[:NLIMBS] + borrow * spec.col("n", a.device))


def neg_body(a, spec: FieldSpec):
    return sub_body(torch.zeros_like(a), a, spec)


_COL_INDEX = {}


def _columns(a, b):
    """Column sums c_k = sum_{i+j=k} a_i b_j, k < 2 NLIMBS - 1, of two
    (NLIMBS, B) int64 limb tensors (either may be a constant column):
    the (i, j) product grid, added into its columns in one index_add."""
    grid = (a.unsqueeze(1) * b.unsqueeze(0)).reshape(NLIMBS * NLIMBS, -1)
    idx = _COL_INDEX.get(str(grid.device))
    if idx is None:
        k = torch.arange(NLIMBS, device=grid.device)
        idx = (k.view(-1, 1) + k.view(1, -1)).reshape(-1)
        _COL_INDEX[str(grid.device)] = idx
    cols = grid.new_zeros((2 * NLIMBS - 1, grid.shape[1]))
    return cols.index_add_(0, idx, grid)


def _fold(x, passes: int):
    """`passes` shift-fold passes (carry_fold2's step); carries out of the
    top row are dropped."""
    for _ in range(passes):
        hi = x >> LIMB_BITS
        x = x & MASK
        x[1:] += hi[:-1]
    return x


def mont_mul_body(a, b, spec: FieldSpec):
    """Montgomery product a*b*2^-256 mod N on (NLIMBS, B) canonical limbs,
    canonical out: lmfield.mont_mul_body's function and steps
    (T = a*b, m = T*N' mod 2^256, (T + m*N) / 2^256, one conditional
    subtract), with whole int64 column sums in place of its uint32
    low/high halves.

    Bounds: T's 31 columns are below 16 * 2^32 = 2^36; m's 16 columns
    below 2^56, folded three times to limbs below 2^16 + 2^9, so m <
    (1 + 2^-7) 2^256 and m = T*N' mod 2^256 as a value (the dropped
    carries are multiples of 2^256); the columns of T + m*N are below
    2^38, its exact carry leaves the low 16 limbs 0, and the high ones
    hold (T + m*N) / 2^256 < N/4 + (1 + 2^-7) N < 2N."""
    t = _columns(a, b)
    m = _fold(_columns(t[:NLIMBS], spec.col("ninv", a.device))[:NLIMBS], 3)
    total = _with_overflow_row(t + _columns(m, spec.col("n", a.device)))
    return cond_sub_n(carry_prop(_fold(total, 1))[NLIMBS:], spec)


def is_zero(a):
    return (a == 0).all(dim=0)


def select(cond, a, b):
    """cond ? a : b with cond shaped like the lane axes."""
    return torch.where(cond.unsqueeze(0), a, b)


def mont_one(spec: FieldSpec, b: int, device, dtype=I32):
    return spec.col("r", device).to(dtype).expand(NLIMBS, b).contiguous()


# ----------------------------------------------------- int32 boundaries

def mont_mul(a, b, spec: FieldSpec):
    """Montgomery multiply of (NLIMBS, B) int32 limb tensors. CUDA tensors
    go to the Hopper kernel (which raises if it cannot run); CPU tensors
    to the plain body."""
    if a.is_cuda:
        return kernels.mont_mul(a, b, spec.kernel_id)
    return mont_mul_body(a.to(I64), b.to(I64), spec).to(I32)


def add(a, b, spec: FieldSpec):
    return add_body(a.to(I64), b.to(I64), spec).to(I32)


def sub(a, b, spec: FieldSpec):
    return sub_body(a.to(I64), b.to(I64), spec).to(I32)


def neg(a, spec: FieldSpec):
    return neg_body(a.to(I64), spec).to(I32)


def pow_bits_body(a, bits, spec: FieldSpec, mul=None):
    """a^e in Montgomery form for an LSB-first exponent bit list, by the
    reference's square-and-multiply; int64 in and out. `mul` defaults to
    the plain body. A zero bit skips the product the reference computes
    and discards, which changes no output."""
    mul = mul or (lambda x, y: mont_mul_body(x, y, spec))
    result = mont_one(spec, a.shape[1], a.device, a.dtype)
    base = a
    for i, bit in enumerate(bits):
        if bit:
            result = mul(result, base)
        if i + 1 < len(bits):
            base = mul(base, base)
    return result


def inv_mont_body(a, spec: FieldSpec):
    """Fermat inversion a^(N-2) in Montgomery form, inv(0) = 0, on int64
    limbs: lmfield.inv_mont's square-and-multiply over the bits of N - 2."""
    return select(is_zero(a), a, pow_bits_body(a, spec.inv_exp_bits, spec))


def inv_mont(a, spec: FieldSpec):
    """Fermat inversion in Montgomery form; inv(0) = 0 (int32 in and out).
    CUDA tensors go to the Hopper inversion kernel (csrc/tower.cu, which
    raises if it cannot run); CPU tensors to the plain body."""
    if a.is_cuda:
        return kernels.fq_inv(a, spec.kernel_id)
    return inv_mont_body(a.to(I64), spec).to(I32)
