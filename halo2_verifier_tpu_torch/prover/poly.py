"""Polynomial utilities for the test-only prover (host, exact).

Radix-2 NTT over Fr, coset extended-domain evaluation, and the small
polynomial ops the SHPLONK/GWC openers need. Sizes are test-scale (n <= 2^14)
so clarity wins over speed here; the device path never uses this module.
"""

from __future__ import annotations

from ..ops.constants import R
from ..ops.hostfield import batch_invert


def ntt(values: list[int], omega: int) -> list[int]:
    """In-order iterative radix-2 NTT: out[i] = sum_j values[j] omega^(ij)."""
    n = len(values)
    assert n & (n - 1) == 0
    a = list(values)
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, R)
        for start in range(0, n, length):
            w = 1
            half = length >> 1
            for i in range(start, start + half):
                u, t = a[i], a[i + half] * w % R
                a[i] = (u + t) % R
                a[i + half] = (u - t) % R
                w = w * w_len % R
        length <<= 1
    return a


def intt(values: list[int], omega: int) -> list[int]:
    n = len(values)
    out = ntt(values, pow(omega, -1, R))
    n_inv = pow(n, -1, R)
    return [v * n_inv % R for v in out]


def eval_poly(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def poly_divide_linear(coeffs: list[int], z: int) -> list[int]:
    """Synthetic division: coeffs / (X - z); remainder must be 0 mod the
    caller's expectations (returned quotient drops it)."""
    out = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (coeffs[i] + acc) % R
        out[i - 1] = acc
        acc = acc * z % R
    return out


def poly_add(a: list[int], b: list[int]) -> list[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R
            for i in range(n)]


def poly_sub(a: list[int], b: list[int]) -> list[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % R
            for i in range(n)]


def poly_scale(a: list[int], s: int) -> list[int]:
    return [c * s % R for c in a]


class DomainOps:
    """FFT-based domain operations bound to an EvaluationDomain."""

    def __init__(self, domain):
        self.d = domain
        self.ext_factor = 1 << (domain.extended_k - domain.k)
        self.ext_n = 1 << domain.extended_k

    def lagrange_to_coeff(self, values: list[int]) -> list[int]:
        assert len(values) == self.d.n
        return intt(values, self.d.omega)

    def coeff_to_lagrange(self, coeffs: list[int]) -> list[int]:
        assert len(coeffs) <= self.d.n
        padded = list(coeffs) + [0] * (self.d.n - len(coeffs))
        return ntt(padded, self.d.omega)

    def coeff_to_extended(self, coeffs: list[int]) -> list[int]:
        """Evaluate on the coset zeta * <omega_ext> (poly/domain.rs:77-79)."""
        padded = list(coeffs) + [0] * (self.ext_n - len(coeffs))
        zeta_pow = 1
        scaled = []
        for c in padded:
            scaled.append(c * zeta_pow % R)
            zeta_pow = zeta_pow * self.d.g_coset % R
        return ntt(scaled, self.d.extended_omega)

    def extended_to_coeff(self, evals: list[int]) -> list[int]:
        coeffs = intt(evals, self.d.extended_omega)
        zeta_inv = pow(self.d.g_coset, -1, R)
        zeta_pow = 1
        out = []
        for c in coeffs:
            out.append(c * zeta_pow % R)
            zeta_pow = zeta_pow * zeta_inv % R
        return out

    def divide_by_vanishing(self, ext_evals: list[int]) -> list[int]:
        """Divide coset-extended evals by t(X) = X^n - 1 using the
        precomputed inverted t evaluations (poly/domain.rs:82-105)."""
        t_inv = self.d.t_evaluations_inv
        m = len(t_inv)
        return [v * t_inv[i % m] % R for i, v in enumerate(ext_evals)]
