"""Frozen copy of halo2_verifier_tpu/protocol/arguments.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

PLONK argument verifiers: permutation, lookup, shuffle, vanishing.

These mirror the reference's typestate pipelines collapsed into small
classes: read commitments from the transcript in protocol order, read evals,
then contribute constraint expressions (scalars folded into h(x)) and
opening queries.

References: plonk/permutation.rs, plonk/lookup.rs, plonk/shuffle.rs,
plonk/vanishing.rs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .constants import FR_DELTA, R
from .columns import ADVICE, FIXED, INSTANCE
from .kzg import MSMKZG
from .queries import VerifierQuery


# ----------------------------------------------------------- permutation

@dataclass
class PermutationCommitted:
    permutation_product_commitments: list

    @classmethod
    def read(cls, vk, transcript):
        """read_product_commitments (permutation.rs:63-84): one product
        commitment per chunk of cs_degree-2 columns."""
        chunk_len = vk.cs_degree - 2
        cols = vk.cs.permutation.columns
        n_chunks = (len(cols) + chunk_len - 1) // chunk_len if cols else 0
        return cls([transcript.read_point() for _ in range(n_chunks)])

    def evaluate(self, transcript) -> "PermutationEvaluated":
        """permutation.rs:105-131."""
        sets = []
        n = len(self.permutation_product_commitments)
        for i, commitment in enumerate(self.permutation_product_commitments):
            ev = transcript.read_scalar()
            next_ev = transcript.read_scalar()
            last_ev = transcript.read_scalar() if i + 1 < n else None
            sets.append((commitment, ev, next_ev, last_ev))
        return PermutationEvaluated(sets)


@dataclass
class PermutationEvaluated:
    # each set: (commitment, eval, next_eval, last_eval|None)
    sets: list

    def expressions(self, vk, common_evals, advice_evals, fixed_evals,
                    instance_evals, l_0, l_last, l_blind, beta, gamma, x):
        """permutation.rs:189-288."""
        out = []
        chunk_len = vk.cs_degree - 2
        columns = vk.cs.permutation.columns
        if self.sets:
            first = self.sets[0]
            out.append(l_0 * (1 - first[1]) % R)
            last = self.sets[-1]
            out.append((last[1] * last[1] - last[1]) % R * l_last % R)
        for prev, cur in zip(self.sets, self.sets[1:]):
            out.append((cur[1] - prev[3]) % R * l_0 % R)

        def col_eval(column):
            idx = vk.cs.get_any_query_index(column, 0)
            if column.kind == ADVICE:
                return advice_evals[idx]
            if column.kind == FIXED:
                return fixed_evals[idx]
            return instance_evals[idx]

        one_minus = (1 - (l_last + l_blind)) % R
        for chunk_index, (set_, cols, perm_evals) in enumerate(
            zip(
                self.sets,
                _chunks(columns, chunk_len),
                _chunks(common_evals, chunk_len),
            )
        ):
            _, product_eval, product_next_eval, _ = set_
            left = product_next_eval
            for column, perm_eval in zip(cols, perm_evals):
                left = left * ((col_eval(column) + beta * perm_eval + gamma) % R) % R
            right = product_eval
            current_delta = (
                beta * x % R * pow(FR_DELTA, chunk_index * chunk_len, R) % R
            )
            for column in cols:
                right = right * ((col_eval(column) + current_delta + gamma) % R) % R
                current_delta = current_delta * FR_DELTA % R
            out.append((left - right) % R * one_minus % R)
        return out

    def queries(self, vk, x, proof_idx):
        """permutation.rs:290-325."""
        blinding_factors = vk.cs.blinding_factors()
        x_next = vk.domain.rotate_omega(x, 1)
        x_last = vk.domain.rotate_omega(x, -(blinding_factors + 1))
        out = []
        for i, (commitment, ev, next_ev, _) in enumerate(self.sets):
            key = ("perm_product", proof_idx, i)
            out.append(VerifierQuery.from_commitment(key, commitment, x, ev))
            out.append(VerifierQuery.from_commitment(key, commitment, x_next, next_ev))
        for i, (commitment, _, _, last_ev) in list(enumerate(self.sets))[-2::-1]:
            key = ("perm_product", proof_idx, i)
            out.append(VerifierQuery.from_commitment(key, commitment, x_last, last_ev))
        return out


@dataclass
class PermutationCommonEvaluated:
    """sigma-polynomial evals (permutation.rs:183-186)."""

    permutation_evals: list

    @classmethod
    def read(cls, vk, transcript):
        return cls([transcript.read_scalar() for _ in vk.permutation.commitments])

    def queries(self, vk, x):
        """permutation.rs:328-340: open each sigma commitment at x."""
        return [
            VerifierQuery.from_commitment(("perm_sigma", i), c, x, ev)
            for i, (c, ev) in enumerate(
                zip(vk.permutation.commitments, self.permutation_evals)
            )
        ]


def _chunks(xs, n):
    return [xs[i: i + n] for i in range(0, len(xs), n)]


# ---------------------------------------------------------------- lookup

@dataclass
class LookupVerifier:
    permuted_input_commitment: tuple = None
    permuted_table_commitment: tuple = None
    product_commitment: tuple = None
    product_eval: int = 0
    product_next_eval: int = 0
    permuted_input_eval: int = 0
    permuted_input_inv_eval: int = 0
    permuted_table_eval: int = 0

    @classmethod
    def read_permuted_commitments(cls, transcript):
        """lookup.rs:82-98."""
        v = cls()
        v.permuted_input_commitment = transcript.read_point()
        v.permuted_table_commitment = transcript.read_point()
        return v

    def read_product_commitment(self, transcript):
        """lookup.rs:107-118."""
        self.product_commitment = transcript.read_point()
        return self

    def evaluate(self, transcript):
        """lookup.rs:127-146."""
        self.product_eval = transcript.read_scalar()
        self.product_next_eval = transcript.read_scalar()
        self.permuted_input_eval = transcript.read_scalar()
        self.permuted_input_inv_eval = transcript.read_scalar()
        self.permuted_table_eval = transcript.read_scalar()
        return self

    def expressions(self, l_0, l_last, l_blind, argument, theta, beta, gamma,
                    coeff_vals, advice_evals, fixed_evals, instance_evals,
                    challenges):
        """lookup.rs:159-230."""
        active_rows = (1 - (l_last + l_blind)) % R

        def compress(exprs):
            acc = 0
            for e in exprs:
                acc = (
                    acc * theta
                    + e.evaluate(coeff_vals, advice_evals, fixed_evals,
                                 instance_evals, challenges)
                ) % R
            return acc

        left = (
            self.product_next_eval
            * ((self.permuted_input_eval + beta) % R)
            % R
            * ((self.permuted_table_eval + gamma) % R)
            % R
        )
        right = (
            self.product_eval
            * ((compress(argument.input_expressions) + beta) % R)
            % R
            * ((compress(argument.table_expressions) + gamma) % R)
            % R
        )
        return [
            l_0 * (1 - self.product_eval) % R,
            l_last * (self.product_eval * self.product_eval - self.product_eval) % R,
            (left - right) % R * active_rows % R,
            l_0 * (self.permuted_input_eval - self.permuted_table_eval) % R,
            (self.permuted_input_eval - self.permuted_table_eval) % R
            * ((self.permuted_input_eval - self.permuted_input_inv_eval) % R)
            % R
            * active_rows
            % R,
        ]

    def queries(self, vk, x, proof_idx, lookup_idx):
        """lookup.rs:232-271."""
        x_inv = vk.domain.rotate_omega(x, -1)
        x_next = vk.domain.rotate_omega(x, 1)
        kp = ("lookup_product", proof_idx, lookup_idx)
        ki = ("lookup_perm_input", proof_idx, lookup_idx)
        kt = ("lookup_perm_table", proof_idx, lookup_idx)
        return [
            VerifierQuery.from_commitment(kp, self.product_commitment, x,
                                          self.product_eval),
            VerifierQuery.from_commitment(ki, self.permuted_input_commitment, x,
                                          self.permuted_input_eval),
            VerifierQuery.from_commitment(kt, self.permuted_table_commitment, x,
                                          self.permuted_table_eval),
            VerifierQuery.from_commitment(ki, self.permuted_input_commitment,
                                          x_inv, self.permuted_input_inv_eval),
            VerifierQuery.from_commitment(kp, self.product_commitment, x_next,
                                          self.product_next_eval),
        ]


# --------------------------------------------------------------- shuffle

@dataclass
class ShuffleVerifier:
    product_commitment: tuple = None
    product_eval: int = 0
    product_next_eval: int = 0

    @classmethod
    def read_product_commitment(cls, transcript):
        """shuffle.rs:116-128."""
        v = cls()
        v.product_commitment = transcript.read_point()
        return v

    def evaluate(self, transcript):
        """shuffle.rs:131-144."""
        self.product_eval = transcript.read_scalar()
        self.product_next_eval = transcript.read_scalar()
        return self

    def expressions(self, l_0, l_last, l_blind, argument, theta, gamma,
                    coeff_vals, advice_evals, fixed_evals, instance_evals,
                    challenges):
        """shuffle.rs:148-203."""
        active_rows = (1 - (l_last + l_blind)) % R

        def compress(exprs):
            acc = 0
            for e in exprs:
                acc = (
                    acc * theta
                    + e.evaluate(coeff_vals, advice_evals, fixed_evals,
                                 instance_evals, challenges)
                ) % R
            return acc

        left = self.product_next_eval * (
            (compress(argument.shuffle_expressions) + gamma) % R
        ) % R
        right = self.product_eval * (
            (compress(argument.input_expressions) + gamma) % R
        ) % R
        return [
            l_0 * (1 - self.product_eval) % R,
            l_last * (self.product_eval * self.product_eval - self.product_eval) % R,
            (left - right) % R * active_rows % R,
        ]

    def queries(self, vk, x, proof_idx, shuffle_idx):
        """shuffle.rs:205-226."""
        x_next = vk.domain.rotate_omega(x, 1)
        key = ("shuffle_product", proof_idx, shuffle_idx)
        return [
            VerifierQuery.from_commitment(key, self.product_commitment, x,
                                          self.product_eval),
            VerifierQuery.from_commitment(key, self.product_commitment, x_next,
                                          self.product_next_eval),
        ]


# ------------------------------------------------------------- vanishing

@dataclass
class VanishingVerifier:
    random_poly_commitment: tuple = None
    h_commitments: list = field(default_factory=list)
    random_eval: int = 0
    expected_h_eval: int = 0
    h_msm: MSMKZG = None

    @classmethod
    def read_commitments_before_y(cls, transcript):
        """vanishing.rs:49-57."""
        v = cls()
        v.random_poly_commitment = transcript.read_point()
        return v

    def read_commitments_after_y(self, vk, transcript):
        """vanishing.rs:61-73."""
        self.h_commitments = transcript.read_n_points(
            vk.domain.get_quotient_poly_degree()
        )
        return self

    def evaluate_after_x(self, transcript):
        """vanishing.rs:77-89."""
        self.random_eval = transcript.read_scalar()
        return self

    def verify(self, expressions, y, xn):
        """vanishing.rs:92-120: fold expressions by y, divide by x^n - 1,
        and Horner-fold the h pieces into one MSM in powers of x^n."""
        h_eval = 0
        for v in expressions:
            h_eval = (h_eval * y + v) % R
        self.expected_h_eval = h_eval * pow(xn - 1, -1, R) % R

        msm = MSMKZG()
        for commitment in reversed(self.h_commitments):
            msm.scale(xn)
            msm.append_term(1, commitment)
        self.h_msm = msm
        return self

    def queries(self, x, proof_idx):
        """vanishing.rs:124-137."""
        return [
            VerifierQuery.from_msm(("h_msm", proof_idx), self.h_msm, x,
                                   self.expected_h_eval),
            VerifierQuery.from_commitment(
                ("random_poly", proof_idx), self.random_poly_commitment, x,
                self.random_eval,
            ),
        ]
