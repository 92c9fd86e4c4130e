"""Frozen copy of halo2_verifier_tpu/protocol/domain.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Evaluation domain over the 2^k multiplicative subgroup of Fr.

Mirrors poly/domain.rs. The verifier uses rotate_omega / l_i_range /
quotient_poly_degree; the extended-domain and coset constants are kept for
the (test-only) prover's quotient computation.
"""

from __future__ import annotations

from dataclasses import dataclass

from .constants import FR_ROOT_OF_UNITY, FR_S, FR_ZETA, R
from .hostfield import batch_invert, inv


@dataclass(frozen=True)
class Rotation:
    """A query rotation relative to the current row (poly/mod.rs:125-142).
    Protocol internals use bare ints; this type is the public API form."""

    value: int = 0

    @classmethod
    def cur(cls) -> "Rotation":
        return cls(0)

    @classmethod
    def prev(cls) -> "Rotation":
        return cls(-1)

    @classmethod
    def next(cls) -> "Rotation":
        return cls(1)

    def __int__(self) -> int:
        return self.value


class EvaluationDomain:
    def __init__(self, j: int, k: int):
        # poly/domain.rs:34-140
        self.quotient_poly_degree = j - 1
        self.k = k
        self.n = 1 << k

        extended_k = k
        while (1 << extended_k) < self.n * self.quotient_poly_degree:
            extended_k += 1
        assert extended_k <= FR_S
        self.extended_k = extended_k

        extended_omega = FR_ROOT_OF_UNITY
        for _ in range(extended_k, FR_S):
            extended_omega = extended_omega * extended_omega % R
        self.extended_omega = extended_omega
        omega = extended_omega
        for _ in range(k, extended_k):
            omega = omega * omega % R
        self.omega = omega

        self.g_coset = FR_ZETA
        self.g_coset_inv = FR_ZETA * FR_ZETA % R

        # t(X) = X^n - 1 over the coset extended domain (poly/domain.rs:82-105)
        t_evals = []
        orig = pow(FR_ZETA, self.n, R)
        step = pow(extended_omega, self.n, R)
        cur = orig
        while True:
            t_evals.append((cur - 1) % R)
            cur = cur * step % R
            if cur == orig:
                break
        assert len(t_evals) == 1 << (extended_k - k)

        inverted = batch_invert(
            t_evals
            + [1 << k, 1 << extended_k, self.n, extended_omega, omega],
            R,
        )
        self.t_evaluations_inv = inverted[:-5]
        self.ifft_divisor = inverted[-5]
        self.extended_ifft_divisor = inverted[-4]
        self.barycentric_weight = inverted[-3]
        self.extended_omega_inv = inverted[-2]
        self.omega_inv = inverted[-1]

    def rotate_omega(self, value: int, rotation: int) -> int:
        """value * omega^rotation (poly/domain.rs:172-182)."""
        if rotation >= 0:
            return value * pow(self.omega, rotation, R) % R
        return value * pow(self.omega_inv, -rotation, R) % R

    def l_i_range(self, x: int, xn: int, rotations) -> list[int]:
        """Barycentric Lagrange-basis evaluations l_i(x) for each rotation i
        (poly/domain.rs:187-212):  l_i(x) = omega^i (x^n - 1) / (n (x - omega^i)).
        """
        rotations = list(rotations)
        denoms = [(x - self.rotate_omega(1, rot)) % R for rot in rotations]
        denoms = batch_invert(denoms, R)
        common = (xn - 1) * self.barycentric_weight % R
        return [
            self.rotate_omega(d * common % R, rot)
            for rot, d in zip(rotations, denoms)
        ]

    def get_quotient_poly_degree(self) -> int:
        return self.quotient_poly_degree
