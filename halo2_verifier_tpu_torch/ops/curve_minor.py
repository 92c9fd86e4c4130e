"""Batched BN254 G1 operations on limb-minor (..., 16) Fq limbs.

Port of halo2_verifier_tpu/ops/curve_jax.py. Points are homogeneous
projective (X, Y, Z) tuples of (..., 16) int32 Montgomery Fq limb tensors
(ops/field_minor.py), identity = (0:1:0); the batch axes broadcast between
the two points of an add. Addition and doubling are the Renes-Costello-
Batina (2015) complete formulas for a = 0: branchless, valid for every
input pair.

- the plain versions follow the reference step for step on field_minor's
  plain bodies: `identity` (curve_jax.py:27), `from_affine` (:33),
  `to_affine_batch` (:46), `add` (:64, algorithm 7 with its stacked
  products), `double` (:105, algorithm 9), `select_point` (:128) and
  `is_identity` (:133), the 3b scalings as products with the reference's
  `_B3` (:23-24) where ops/curve.py uses an add chain (same canonical
  value). They run for CPU tensors, and on the card only where a caller
  passes plain=True;
- for CUDA tensors `add` is one K2 launch (csrc/point_add.cu, no mask or
  gather), `double` one K3 launch (csrc/point_double.cu), and
  `to_affine_batch` T3 on Z, two K1 products and the identity select, all
  on the limbs-major layout through field_minor's `to_major` and
  `to_minor` (every coordinate copied in and each result coordinate
  copied back out to its own contiguous tensor).
"""

from __future__ import annotations

import torch

from . import field_minor as fm
from . import kernels
from .constants import B_G1, P
from .field import FQ, I32, I64
from .limbs import NLIMBS, int_to_limbs

# b3 = 3b = 9 in Montgomery form
_B3_INT = (3 * B_G1) % P
_B3_LIMBS = [int(v) for v in int_to_limbs(_B3_INT * FQ.mont_r % P)]


def identity(shape, device):
    zero = torch.zeros(tuple(shape) + (NLIMBS,), dtype=I32, device=device)
    return (zero, fm.mont_one(FQ, shape, device), zero.clone())


def from_affine(x, y):
    """(x, y) Montgomery limb tensors -> projective; (0, 0) maps to the
    identity (the host side's convention for the point at infinity)."""
    inf = fm.is_zero(x) & fm.is_zero(y)
    one = fm.mont_one(FQ, x.shape[:-1], x.device)
    zero = torch.zeros_like(x)
    return (fm.select(inf, zero, x), fm.select(inf, one, y),
            fm.select(inf, zero, one))


def select_point(cond, p, q):
    """cond ? p : q, batched over the leading axes."""
    return tuple(fm.select(cond, a, b) for a, b in zip(p, q))


def is_identity(p):
    return fm.is_zero(p[2])


# ------------------------------------------------------------ plain bodies
# int64 coordinates in and out.

def _ad(a, b):
    return fm._add(a, b, FQ)


def _sb(a, b):
    return fm._sub(a, b, FQ)


def _mul(a, b):
    return fm._mont_mul(a, b, FQ)


def _b3(device):
    return torch.tensor(_B3_LIMBS, dtype=I64, device=device)


def _add(p, q):
    """RCB15 algorithm 7 with the reference's stacked products."""
    X1, Y1, Z1, X2, Y2, Z2 = torch.broadcast_tensors(*p, *q)
    st = torch.stack
    s = _ad(st([X1, Y1, X1, X2, Y2, X2]), st([Y1, Z1, Z1, Y2, Z2, Z2]))
    t0, t1, t2, m3, m4, m5 = _mul(st([X1, Y1, Z1, s[0], s[1], s[2]]),
                                  st([X2, Y2, Z2, s[3], s[4], s[5]])).unbind()
    sums = _ad(st([t0, t1, t0]), st([t1, t2, t2]))
    t3, t4, y3 = _sb(st([m3, m4, m5]), sums).unbind()
    t2b, y3b = _mul(st([t2, y3]), _b3(X1.device)).unbind()
    x3 = _ad(_ad(t0, t0), t0)  # 3 t0
    z3 = _ad(t1, t2b)
    t1m = _sb(t1, t2b)
    e = _mul(st([t3, t4, y3b, t1m, z3, x3]), st([t1m, y3b, x3, z3, t4, t3]))
    X3 = _sb(e[0], e[1])
    yz = _ad(st([e[2], e[4]]), st([e[3], e[5]]))
    return (X3, yz[0], yz[1])


def _double(p):
    """RCB15 algorithm 9, stacked like _add."""
    X, Y, Z = torch.broadcast_tensors(*p)
    st = torch.stack
    t0, t1, t2raw, t3 = _mul(st([Y, Y, Z, X]), st([Y, Z, Z, Y])).unbind()
    t2 = _mul(t2raw, _b3(X.device))
    z3 = _ad(_ad(t0, t0), _ad(t0, t0))
    z3 = _ad(z3, z3)  # 8 Y^2
    y3 = _ad(t0, t2)
    t0m = _sb(t0, _ad(_ad(t2, t2), t2))  # t0 - 3 t2
    e = _mul(st([t2, t1, t0m, t0m]), st([z3, z3, y3, t3]))
    return (_ad(e[3], e[3]), _ad(e[0], e[2]), e[1])


def _plain(body, *cs):
    return tuple(c.to(I32) for c in body(*(c.to(I64) for c in cs)))


# ---------------------------------------------------------- public functions

def add(p, q, plain: bool = False):
    """Complete addition P + Q. CUDA tensors: one K2 launch (raises if it
    cannot run) unless plain=True; CPU tensors: the plain version."""
    if p[0].is_cuda and not plain:
        shape, cs = fm.to_major(*p, *q)
        out = kernels.point_add(tuple(cs[:3]), tuple(cs[3:]))
        return tuple(fm.to_minor(c, shape) for c in out)
    return _plain(lambda *cs: _add(cs[:3], cs[3:]), *p, *q)


def double(p, plain: bool = False):
    """Complete doubling 2P. CUDA tensors: one K3 launch (raises if it
    cannot run) unless plain=True; CPU tensors: the plain version."""
    if p[0].is_cuda and not plain:
        shape, cs = fm.to_major(*p)
        return tuple(fm.to_minor(c, shape)
                     for c in kernels.point_double(tuple(cs)))
    return _plain(lambda *cs: _double(cs), *p)


def to_affine_batch(pt, plain: bool = False):
    """Projective -> affine Montgomery (x, y); the identity maps to
    (0, 0). CUDA tensors: one T3 launch on Z and two K1 launches (raise if
    they cannot run) unless plain=True; CPU tensors: the plain version."""
    X, Y, Z = pt
    if Z.is_cuda and not plain:
        shape, (X, Y, Z) = fm.to_major(X, Y, Z)
        zinv = kernels.fq_inv(Z, FQ.kernel_id)
        inf = (Z == 0).all(dim=0)
        return tuple(
            fm.to_minor(torch.where(inf, 0, kernels.mont_mul(
                c, zinv, FQ.kernel_id)), shape)
            for c in (X, Y))
    zinv = fm.inv_mont(Z, FQ, plain=True)
    x = fm.mont_mul(X, zinv, FQ, plain=True)
    y = fm.mont_mul(Y, zinv, FQ, plain=True)
    inf = fm.is_zero(Z)
    return (fm.select(inf, torch.zeros_like(x), x),
            fm.select(inf, torch.zeros_like(y), y))
