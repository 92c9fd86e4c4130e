"""Device G1-decompression pre-pass: batched principal square roots.

Port of halo2_verifier_tpu/ops/decomp_jax.py. Halo2 proofs carry
compressed G1 points; decompression needs y = sqrt(x^3 + 3), a Fermat
power of ~380 products per point. The transcript read schedule is
vk-static, so the host gathers every proof point's x up front
(CompiledReplay.gather_point_xs); this module computes the principal roots
y0 = (x^3 + 3)^((q+1)/4) for the whole batch in one device launch, and the
VM only checks y0^2 == x^3 + 3 and applies the sign bit. A wrong y0
rejects the proof exactly like a failed sqrt, so soundness never depends
on the device result.

On the card the whole exponentiation is one launch of the square-root
kernel (csrc/mont_mul.cu), which keeps each lane's state in registers and
runs the exponent by a fixed window of SQRT_WINDOW bits. The plain
version `y_principal_plain` runs the same schedule (`pow_window`) on the
plain bodies, and `y_principal_k1`, the simple port, as a Python loop of
Montgomery-multiply launches; both serve as yardsticks. Every schedule
gives the reference's roots: each step's result is a canonical residue.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as fm
from . import kernels
from .constants import P
from .field import FQ, I32, I64
from .limbs import NLIMBS, int_to_limbs

# pad widths quantize to this, as in the reference
PAD_GRAN = 1024

# the exponent (q + 1) / 4, and the square-root kernel's window width
# (csrc/mont_mul.cu SqrtShape::kWindow; tests/test_torch_decomp.py checks
# that the two agree)
SQRT_EXP = (P + 1) // 4
SQRT_WINDOW = 4

_B_MONT = [int(v) for v in int_to_limbs(3 * FQ.mont_r % P)]
_ONE = [int(v) for v in int_to_limbs(1)]


def _col(vals, like):
    return torch.tensor(vals, dtype=like.dtype, device=like.device).reshape(
        NLIMBS, 1).expand_as(like).contiguous()


def window_digits(e: int, w: int):
    """e's digits in base 2^w, most significant first."""
    n = -(-e.bit_length() // w)
    return [(e >> (w * k)) & ((1 << w) - 1) for k in reversed(range(n))]


def pow_window(a, e: int, w: int, mul):
    """a^e by a fixed window of w bits, most significant digit first: the
    table a^1..a^(2^w - 1) (one squaring, then products by a), then per
    lower digit w squarings and a product by the table's entry unless the
    digit is 0. The schedule of the square-root kernel's pow_sqrt_exp."""
    tab = [None, a]
    for d in range(2, 1 << w):
        tab.append(mul(tab[1], tab[1]) if d == 2 else mul(tab[d - 1], a))
    digits = window_digits(e, w)
    r = tab[digits[0]]
    for d in digits[1:]:
        for _ in range(w):
            r = mul(r, r)
        if d:
            r = mul(r, tab[d])
    return r


def window_chain_counts(e: int, w: int):
    """(squarings, multiplies) of pow_window(a, e, w): the table's one
    squaring and 2^w - 3 products, then w squarings per lower digit and a
    product per nonzero one."""
    digits = window_digits(e, w)
    return ((1 if w > 1 else 0) + w * (len(digits) - 1),
            max((1 << w) - 3, 0) + sum(1 for d in digits[1:] if d))


def sqrt_chain_counts(w: int = SQRT_WINDOW):
    """(squarings, multiplies) of the square-root kernel per lane: x R'
    (one product), x^2, x^3, the window's chain, and one product out of
    Montgomery form."""
    squarings, multiplies = window_chain_counts(SQRT_EXP, w)
    return 1 + squarings, 3 + multiplies


def _y_chain(xs, mul, add):
    """The reference's _y_principal over the given multiply and add, the
    exponent by the kernel's window schedule."""
    xm = mul(xs, FQ.col("r2", xs.device).to(xs.dtype).expand_as(xs)
             .contiguous())
    x2 = mul(xm, xm)
    x3 = mul(x2, xm)
    rhs = add(x3, _col(_B_MONT, xs))
    y = pow_window(rhs, SQRT_EXP, SQRT_WINDOW, mul)
    return mul(y, _col(_ONE, xs))  # from Montgomery


def y_principal_plain(xs):
    """Plain version: (NLIMBS, B) int32 canonical x limbs -> int32
    canonical principal roots, on the plain torch bodies."""
    out = _y_chain(xs.to(I64), lambda a, b: fm.mont_mul_body(a, b, FQ),
                   lambda a, b: fm.add_body(a, b, FQ))
    return out.to(I32)


def y_principal_k1(xs):
    """The simple port: every product one Montgomery-multiply launch
    (322 launches per call)."""
    return _y_chain(xs, lambda a, b: fm.mont_mul(a, b, FQ),
                    lambda a, b: fm.add(a, b, FQ))


def y_principal(xs, beside=None):
    """(NLIMBS, B) int32 canonical x limbs -> canonical principal roots:
    one fused kernel launch for a CUDA tensor, the plain version for a CPU
    tensor. For a non-residue x^3+3 (or an x off the curve) the result
    fails the VM's y0^2 check. beside: a kernels.HostCopy the launch
    queues with it (kernels.sqrt_principal), CUDA only."""
    if xs.is_cuda:
        return kernels.sqrt_principal(xs, beside)
    if beside is not None:
        raise ValueError("y_principal: a copy beside the plain version")
    return y_principal_plain(xs)


def stage_x_batch(x_limbs_np, device):
    """(M, NLIMBS) uint32 canonical x limbs -> the (NLIMBS, pad) int32
    host tensor launch_y_batch uploads, pad M rounded up to PAD_GRAN; in
    pinned memory where `device` is CUDA, so that the upload does not
    block the host."""
    m = x_limbs_np.shape[0]
    pad = max(-(-m // PAD_GRAN) * PAD_GRAN, PAD_GRAN)
    xs = np.zeros((NLIMBS, pad), dtype=np.int32)
    xs[:, :m] = x_limbs_np.T
    xs = torch.from_numpy(xs)
    return xs.pin_memory() if torch.device(device).type == "cuda" else xs


def launch_y_batch(xs, device, beside=None):
    """stage_x_batch's tensor -> its principal roots on `device`: the
    upload and the launch queued, nothing synchronized; beside: as
    y_principal's."""
    return y_principal(xs.to(device, non_blocking=True), beside)


def dispatch_y_batch(x_limbs_np, device):
    """(M, NLIMBS) uint32 canonical x limbs -> (NLIMBS, pad) int32 tensor
    of principal roots on `device`, without synchronizing; pad is M
    rounded up to PAD_GRAN."""
    return launch_y_batch(stage_x_batch(x_limbs_np, device), device)
