"""Batched BN254 G1 ops, limbs-major: plain torch bodies + the Hopper
point kernels.

Port of halo2_verifier_tpu/ops/lmcurve.py. Points are homogeneous
projective (X:Y:Z) triples of limbs-major Montgomery Fq limb tensors,
identity = (0:1:0). Addition and doubling use the Renes-Costello-Batina
(2015) complete formulas for a = 0, branchless and valid for every input
pair, in exactly the reference's operation order: every intermediate is a
canonical residue, so the projective outputs equal the reference's bit for
bit.

Two limb formats share this code through `PointOps`, as in the reference:
- OPS16 over ops/field.py: (16, B) int32 rows of 16-bit limbs (bodies on
  int64);
- OPS8 over ops/field8.py: (32, B) float32 rows of 8-bit limbs.
The module-level functions are the OPS16 aliases.

`masked_add` and `add` launch the point-add kernel of their format
(csrc/point_add.cu, csrc/point_add8.cu) for CUDA tensors, with the gather
by iL/iR fused into it, and `double` launches the doubling kernel
(csrc/point_double.cu); for CPU tensors they run the plain bodies after
plain gathers.
"""

from __future__ import annotations

import torch

from . import field as fm
from . import field8 as f8
from . import kernels
from .constants import B_G1
from .field import FQ, I32, I64
from .limbs import NLIMBS

assert B_G1 == 3, "the x9 add chain below assumes b=3 (3b=9)"


class PointOps:
    """Complete G1 point operations over one limb format.

    lfm: field module (ops/field.py or ops/field8.py) providing
    mont_mul_body, add_body, sub_body, select, is_zero over (nlimbs, B)
    tensors. dtype is the format's storage type; the bodies run on
    body_dtype (int64 for the 16-bit limbs: torch on the CPU has no uint32
    arithmetic). kernel is the format's point-add wrapper in ops/kernels.
    """

    CPU_BLOCK = 1024  # lanes per block of the plain add on CPU tensors

    def __init__(self, lfm, nlimbs: int, dtype, body_dtype, kernel, tag: str):
        self.lfm = lfm
        self.nlimbs = nlimbs
        self.dtype = dtype
        self.body_dtype = body_dtype
        self.kernel = kernel
        self.tag = tag

    # ------------------------------------------------------ field helpers
    def _mul(self, a, b):
        return self.lfm.mont_mul_body(a, b, FQ)

    def _add(self, a, b):
        return self.lfm.add_body(a, b, FQ)

    def _sub(self, a, b):
        return self.lfm.sub_body(a, b, FQ)

    def _mul_b3(self, x):
        """x * 3b = x * 9 via an add chain (Montgomery form is linear)."""
        d1 = self._add(x, x)
        d2 = self._add(d1, d1)
        d3 = self._add(d2, d2)
        return self._add(d3, x)

    def _wide(self, p):
        return tuple(c.to(self.body_dtype) for c in p)

    def _narrow(self, p):
        return tuple(c.to(self.dtype) for c in p)

    def mont_one(self, b: int, device):
        """Montgomery one as (nlimbs, b) limbs of this format."""
        return self.lfm.mont_one(FQ, b, device)

    # -------------------------------------------------------- point bodies
    def identity(self, b: int, device):
        zero = torch.zeros((self.nlimbs, b), dtype=self.dtype, device=device)
        return (zero, self.mont_one(b, device), zero.clone())

    def from_affine(self, x, y):
        """(x, y) Montgomery limb tensors -> projective; (0, 0) =
        identity."""
        inf = self.lfm.is_zero(x) & self.lfm.is_zero(y)
        one = self.mont_one(x.shape[1], x.device)
        zero = torch.zeros_like(x)
        return (
            self.lfm.select(inf, zero, x),
            self.lfm.select(inf, one, y),
            self.lfm.select(inf, zero, one),
        )

    def add_body(self, p, q):
        """Complete addition (RCB15 algorithm 7, a = 0) on body_dtype
        limbs."""
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        mul, ad, sb = self._mul, self._add, self._sub
        t0 = mul(X1, X2)
        t1 = mul(Y1, Y2)
        t2 = mul(Z1, Z2)
        t3 = sb(mul(ad(X1, Y1), ad(X2, Y2)), ad(t0, t1))
        t4 = sb(mul(ad(Y1, Z1), ad(Y2, Z2)), ad(t1, t2))
        y3 = sb(mul(ad(X1, Z1), ad(X2, Z2)), ad(t0, t2))
        t2b = self._mul_b3(t2)
        x3 = ad(ad(t0, t0), t0)  # 3*t0
        z3 = ad(t1, t2b)
        t1m = sb(t1, t2b)
        y3b = self._mul_b3(y3)
        X3 = sb(mul(t3, t1m), mul(t4, y3b))
        Y3 = ad(mul(y3b, x3), mul(t1m, z3))
        Z3 = ad(mul(z3, t4), mul(x3, t3))
        return (X3, Y3, Z3)

    def double_body(self, p):
        """Complete doubling (RCB15 algorithm 9, a = 0) on body_dtype
        limbs."""
        X, Y, Z = p
        mul, ad, sb = self._mul, self._add, self._sub
        t0 = mul(Y, Y)
        t1 = mul(Y, Z)
        t2 = self._mul_b3(mul(Z, Z))
        t3 = mul(X, Y)
        z3 = ad(ad(t0, t0), ad(t0, t0))
        z3 = ad(z3, z3)
        y3 = ad(t0, t2)
        t0m = sb(t0, ad(ad(t2, t2), t2))
        x3 = mul(t0m, t3)
        x3 = ad(x3, x3)
        y3 = ad(mul(t2, z3), mul(t0m, y3))
        z3 = mul(t1, z3)
        return (x3, y3, z3)

    def select_point(self, cond, p, q):
        return tuple(self.lfm.select(cond, a, b) for a, b in zip(p, q))

    def is_identity(self, p):
        return self.lfm.is_zero(p[2])

    # ------------------------------------------------- kernel boundaries
    def masked_add_plain(self, p, q, mask=None, iL=None, iR=None):
        """Plain version of the point-add kernel: gather, add_body,
        select."""
        if iL is not None:
            p = tuple(c.index_select(1, iL.to(I64)) for c in p)
        if iR is not None:
            q = tuple(c.index_select(1, iR.to(I64)) for c in q)
        width = p[0].shape[1]
        if p[0].is_cuda or width <= 2 * self.CPU_BLOCK:
            r = self._narrow(self.add_body(self._wide(p), self._wide(q)))
        else:
            # on the CPU the body's hundreds of intermediates stay in cache
            # when the lanes go through in blocks; same values either way
            parts = [
                self._narrow(self.add_body(
                    self._wide(tuple(c[:, s:s + self.CPU_BLOCK] for c in p)),
                    self._wide(tuple(c[:, s:s + self.CPU_BLOCK] for c in q))))
                for s in range(0, width, self.CPU_BLOCK)
            ]
            r = tuple(torch.cat([part[c] for part in parts], dim=1)
                      for c in range(3))
        if mask is None:
            return r
        return self.select_point(mask.to(torch.bool), r, p)

    def masked_add(self, p, q, mask=None, iL=None, iR=None):
        """mask ? P + Q : P with P = p[:, iL], Q = q[:, iR] (each gather
        optional): one kernel launch for CUDA tensors, the plain version
        for CPU tensors. iL/iR are int32 index tensors; mask is bool or
        uint8. The output is a new tensor."""
        if p[0].is_cuda:
            return self.kernel(p, q, mask, iL, iR)
        return self.masked_add_plain(p, q, mask, iL, iR)

    def add(self, p, q):
        return self.masked_add(p, q)

    def double_plain(self, p):
        return self._narrow(self.double_body(self._wide(p)))


OPS16 = PointOps(fm, NLIMBS, I32, I64, kernels.point_add, "u16")
OPS8 = PointOps(f8, f8.NLIMBS8, f8.F32, f8.F32, kernels.point_add8, "f8")


# ------------------------------------------------- module-level API (OPS16)

def identity(b: int, device):
    return OPS16.identity(b, device)


def from_affine(x, y):
    return OPS16.from_affine(x, y)


def add_body(p, q):
    return OPS16.add_body(p, q)


def double_body(p):
    return OPS16.double_body(p)


def select_point(cond, p, q):
    return OPS16.select_point(cond, p, q)


def is_identity(p):
    return OPS16.is_identity(p)


def masked_add_plain(p, q, mask=None, iL=None, iR=None):
    return OPS16.masked_add_plain(p, q, mask, iL, iR)


def masked_add(p, q, mask=None, iL=None, iR=None):
    return OPS16.masked_add(p, q, mask, iL, iR)


def add(p, q):
    return OPS16.add(p, q)


def double_plain(p):
    """Plain version of the doubling kernel."""
    return OPS16.double_plain(p)


def double(p):
    """Complete doubling of (16, B) int32 points: the doubling kernel for
    CUDA tensors, the plain body for CPU tensors."""
    if p[0].is_cuda:
        return kernels.point_double(p)
    return double_plain(p)


def to_affine_host(proj_np):
    """Projective -> affine on the HOST: proj_np is a tuple of 3 numpy or
    torch limbs-major Montgomery arrays, (16, B) 16-bit limbs or (32, B)
    float32 8-bit limbs. Returns a list of (x, y) int pairs (None for
    identity). Exact Python-int math; used for the handful of final
    points per MSM."""
    import numpy as np

    from .constants import P
    from .hostfield import batch_invert
    from .limbs import limbs_to_ints

    def col_ints(arr):
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        arr = np.asarray(arr)
        if arr.shape[0] == NLIMBS:  # 16-bit limbs
            return limbs_to_ints(arr.T)
        packed = np.ascontiguousarray(arr.T.astype(np.uint8))  # 8-bit limbs
        return [int.from_bytes(row.tobytes(), "little") for row in packed]

    rinv = pow(FQ.mont_r, -1, P)
    xs = [v * rinv % P for v in col_ints(proj_np[0])]
    ys = [v * rinv % P for v in col_ints(proj_np[1])]
    zs = [v * rinv % P for v in col_ints(proj_np[2])]
    zinv = batch_invert(zs, P)
    out = []
    for x, y, zi, z in zip(xs, ys, zinv, zs):
        if z == 0:
            out.append(None)
        else:
            out.append((x * zi % P, y * zi % P))
    return out
