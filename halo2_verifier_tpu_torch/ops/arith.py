"""Scalar/point utility kernels — the reference's L1 API surface
(arithmetic.rs); port of halo2_verifier_tpu/ops/arith.py. These are the
host-exact forms; the throughput paths are the device kernels
(ops/msm_forest.py and ops/msm_scan.py for best_multiexp, batched field
ops in ops/field.py) and the traced-VM replay (protocol/trace.py) which
inlines eval_polynomial / lagrange_interpolate / powers into per-vk
programs.
"""

from __future__ import annotations

from .constants import R
from . import hostcurve as hc
from . import hostfield as hf


def best_multiexp(scalars, points):
    """MSM dispatch (arithmetic.rs:102-108): host Pippenger for small
    inputs, the grouped device MSM for batch sizes (which callers drive
    directly through ops/msm_forest.py — this convenience form stays exact
    and synchronous)."""
    return hc.g1_msm(list(scalars), list(points))


def eval_polynomial(poly, point: int) -> int:
    """Horner evaluation (arithmetic.rs:137-144)."""
    acc = 0
    for c in reversed(list(poly)):
        acc = (acc * point + c) % R
    return acc


def compute_inner_product(a, b) -> int:
    """Sum of products (arithmetic.rs:113-123)."""
    acc = 0
    for x, y in zip(a, b):
        acc = (acc + x * y) % R
    return acc


def lagrange_interpolate(points, evals):
    """Dense coefficients of the unique interpolant with batch-inverted
    denominators (arithmetic.rs:149-202)."""
    from ..protocol.shplonk import lagrange_interpolate as impl

    return impl(list(points), list(evals))


def evaluate_vanishing_polynomial(roots, z: int) -> int:
    """prod (z - root) (arithmetic.rs:204-206)."""
    acc = 1
    for root in roots:
        acc = acc * ((z - root) % R) % R
    return acc


def powers(base: int):
    """1, base, base^2, ... (arithmetic.rs:208-210)."""
    acc = 1
    while True:
        yield acc
        acc = acc * base % R


def parallelize(items, f):
    """The reference's parallelize is a serial chunk=1 stub
    (arithmetic.rs:127-134); here the analogue of 'parallel' is batching
    onto the device/VM, so this helper is likewise a plain map retained
    for API parity."""
    return [f(x) for x in items]


batch_invert = hf.batch_invert
