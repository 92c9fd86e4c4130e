"""Test-only PLONK prover producing proofs the verifier accepts.

This stands in for the upstream `halo2_proofs::create_proof` +
ProverSHPLONK/ProverGWC the reference tests rely on (tests/helpers.rs:34-64).
Everything mirrors the verifier's transcript read order in
protocol/verifier.py exactly; the SHPLONK/GWC openers implement BDFG20 /
GWC19 against the same rotation-set grouping as the verifier.

Host-side, exact arithmetic; used only for fixture generation and tests.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..ops.constants import FR_DELTA, R
from ..ops.hostfield import batch_invert
from ..protocol.shplonk import (
    construct_intermediate_sets,
    evaluate_vanishing_polynomial,
    lagrange_interpolate,
)
from ..protocol.queries import VerifierQuery
from .keygen import ProvingKey, commit_coeff, commit_lagrange
from .poly import DomainOps, eval_poly, poly_divide_linear, poly_scale, poly_sub

# ---------------------------------------------------------------- helpers


def _prf(seed: bytes, *tags) -> int:
    h = hashlib.blake2b(seed)
    for t in tags:
        h.update(str(t).encode())
    return int.from_bytes(h.digest(), "little") % R


def _arr_mul(a, b):
    return [x * y % R for x, y in zip(a, b)]


def _arr_add(a, b):
    return [(x + y) % R for x, y in zip(a, b)]


def _arr_sub(a, b):
    return [(x - y) % R for x, y in zip(a, b)]


def _arr_addc(a, c):
    return [(x + c) % R for x in a]


def _arr_scale(a, c):
    return [x * c % R for x in a]


def _rotated(arr, shift):
    shift %= len(arr)
    return arr[shift:] + arr[:shift]


class _Poly:
    """A committed polynomial: Lagrange values + cached coefficients."""

    def __init__(self, ops: DomainOps, values=None, coeffs=None):
        self.ops = ops
        self.values = values
        self._coeffs = coeffs
        self._ext = None

    @property
    def coeffs(self):
        if self._coeffs is None:
            self._coeffs = self.ops.lagrange_to_coeff(self.values)
        return self._coeffs

    @property
    def ext(self):
        if self._ext is None:
            self._ext = self.ops.coeff_to_extended(self.coeffs)
        return self._ext

    def eval(self, x: int) -> int:
        return eval_poly(self.coeffs, x)


@dataclass
class ProverQuery:
    point: int
    commit_key: tuple
    poly: object  # _Poly or raw coeff list


# ------------------------------------------------------------ the prover


def create_proof(pk: ProvingKey, assignments, transcript,
                 multiopen: str = "shplonk", seed: bytes = b"proof",
                 unchecked: bool = False) -> bytes:
    """Produce a proof. With unchecked=True the prover's own satisfiability
    asserts (lookup membership, grand-product telescoping, quotient-degree
    overflow) are skipped and a well-formed but INVALID proof is emitted —
    the analogue of the reference's tampered-witness negative tests
    (tests/shuffle.rs:287-308), where rejection must come from the
    *verifier* (pairing failure), not the prover."""
    vk, spec, srs = pk.vk, pk.spec, pk.srs
    cs, domain = vk.cs, vk.domain
    ops = DomainOps(domain)
    n = spec.n
    num_proofs = len(assignments)
    bf = cs.blinding_factors()
    usable = n - (bf + 1)  # row index of l_last; witness rows are 0..usable-1

    instances = [a.instance for a in assignments]

    vk.hash_into(transcript)
    for instance in instances:
        for column in instance:
            for value in column:
                transcript.common_scalar(value)

    # instance columns as zero-padded polynomials (QUERY_INSTANCE=false path:
    # the verifier evaluates them barycentrically from the raw values)
    instance_polys = [
        [_Poly(ops, list(col) + [0] * (n - len(col))) for col in instance]
        for instance in instances
    ]
    fixed_polys = [_Poly(ops, list(col)) for col in spec.fixed_values]
    sigma_polys = [_Poly(ops, list(col)) for col in pk.sigma_values]

    # ---- phase loop: advice commitments + in-circuit challenges ----------
    advice_polys = [[None] * len(spec.advice_phase) for _ in range(num_proofs)]
    challenges = [0] * cs.num_challenges
    challenge_seen: dict[int, int] = {}
    for current_phase in cs.phases():
        for p, asg in enumerate(assignments):
            filler = asg.phase_fillers.get(current_phase)
            if filler is not None:
                filler(challenge_seen)
            for i, phase in enumerate(cs.advice_column_phase):
                if phase != current_phase:
                    continue
                values = [v % R for v in asg.advice[i]]
                for row in range(usable, n):
                    values[row] = _prf(seed, "advice-blind", p, i, row)
                poly = _Poly(ops, values)
                advice_polys[p][i] = poly
                transcript.write_point(commit_lagrange(srs, values))
        for i, phase in enumerate(cs.challenge_phase):
            if phase == current_phase:
                challenges[i] = transcript.squeeze_challenge()
                challenge_seen[i] = challenges[i]

    theta = transcript.squeeze_challenge()

    # row-wise evaluation of a compiled expression over the n-domain
    def rowwise(expr_poly, p):
        def var_array(idx):
            a_r = len(cs.advice_queries)
            f_r = a_r + len(cs.fixed_queries)
            i_r = f_r + len(cs.instance_queries)
            if idx < a_r:
                col, rot = cs.advice_queries[idx]
                return _rotated(advice_polys[p][col.index].values, rot)
            if idx < f_r:
                col, rot = cs.fixed_queries[idx - a_r]
                return _rotated(fixed_polys[col.index].values, rot)
            if idx < i_r:
                col, rot = cs.instance_queries[idx - f_r]
                return _rotated(instance_polys[p][col.index].values, rot)
            return [challenges[idx - i_r]] * n

        out = [0] * n
        for ci, term in expr_poly.terms:
            prod = [cs.coeff_vals[ci]] * n
            for v, pw in term:
                arr = var_array(v)
                for _ in range(pw):
                    prod = _arr_mul(prod, arr)
            out = _arr_add(out, prod)
        return out

    def compress_rowwise(exprs, p):
        acc = [0] * n
        for e in exprs:
            acc = _arr_add(_arr_scale(acc, theta), rowwise(e, p))
        return acc

    # ---- lookups: permuted columns -------------------------------------
    lookup_data = []  # [proof][lookup] dict
    for p in range(num_proofs):
        per_proof = []
        for li, argument in enumerate(cs.lookups):
            a_comp = compress_rowwise(argument.input_expressions, p)
            s_comp = compress_rowwise(argument.table_expressions, p)
            a_vals = a_comp[:usable]
            s_vals = s_comp[:usable]
            a_sorted = sorted(a_vals)
            remaining = {}
            for v in s_vals:
                remaining[v] = remaining.get(v, 0) + 1
            s_perm = [None] * usable
            for i, v in enumerate(a_sorted):
                if i == 0 or v != a_sorted[i - 1]:
                    if remaining.get(v, 0) > 0:
                        remaining[v] -= 1
                        s_perm[i] = v
                    else:
                        assert unchecked, "lookup input not in table"
                        # leave the slot for a leftover table value; the
                        # permuted-column consistency constraint will fail
                        # at the verifier
            leftovers = [v for v, c in remaining.items() for _ in range(c)]
            it = iter(leftovers)
            for i in range(usable):
                if s_perm[i] is None:
                    s_perm[i] = next(it)
            a_full = a_sorted + [
                _prf(seed, "lk-a", p, li, r) for r in range(usable, n)
            ]
            s_full = s_perm + [
                _prf(seed, "lk-s", p, li, r) for r in range(usable, n)
            ]
            pa, ps = _Poly(ops, a_full), _Poly(ops, s_full)
            transcript.write_point(commit_lagrange(srs, a_full))
            transcript.write_point(commit_lagrange(srs, s_full))
            per_proof.append({
                "a_comp": a_comp, "s_comp": s_comp,
                "a_perm": pa, "s_perm": ps,
            })
        lookup_data.append(per_proof)

    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    # ---- permutation grand products ------------------------------------
    chunk_len = pk.cs_degree - 2
    perm_cols = cs.permutation.columns
    perm_z_polys = [[] for _ in range(num_proofs)]
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * domain.omega % R

    def column_values(col, p):
        if col.kind == "advice":
            return advice_polys[p][col.index].values
        if col.kind == "fixed":
            return fixed_polys[col.index].values
        return instance_polys[p][col.index].values

    for p in range(num_proofs):
        carry = 1
        for ci in range(0, len(perm_cols), chunk_len):
            cols = perm_cols[ci: ci + chunk_len]
            sigmas = pk.sigma_values[ci: ci + chunk_len]
            dpow = [pow(FR_DELTA, ci + j, R) for j in range(len(cols))]
            z = [0] * n
            z[0] = carry
            denoms = []
            for row in range(usable):
                den = 1
                for col, sig in zip(cols, sigmas):
                    v = column_values(col, p)[row]
                    den = den * ((v + beta * sig[row] + gamma) % R) % R
                denoms.append(den)
            denoms = batch_invert(denoms, R)
            for row in range(usable):
                num = 1
                for j, col in enumerate(cols):
                    v = column_values(col, p)[row]
                    num = num * (
                        (v + dpow[j] * beta % R * omega_pows[row] + gamma) % R
                    ) % R
                z[row + 1] = z[row] * num % R * denoms[row] % R
            carry = z[usable]
            for row in range(usable + 1, n):
                z[row] = _prf(seed, "perm-z", p, ci, row)
            poly = _Poly(ops, z)
            perm_z_polys[p].append(poly)
            transcript.write_point(commit_lagrange(srs, z))
        if perm_cols and not unchecked:
            assert carry == 1, "copy constraints unsatisfied"

    # ---- lookup grand products -----------------------------------------
    for p in range(num_proofs):
        for li, data in enumerate(lookup_data[p]):
            z = [0] * n
            z[0] = 1
            denoms = [
                (data["a_perm"].values[r] + beta) % R
                * ((data["s_perm"].values[r] + gamma) % R) % R
                for r in range(usable)
            ]
            denoms = batch_invert(denoms, R)
            for r in range(usable):
                num = (data["a_comp"][r] + beta) % R * (
                    (data["s_comp"][r] + gamma) % R
                ) % R
                z[r + 1] = z[r] * num % R * denoms[r] % R
            assert unchecked or z[usable] == 1, \
                "lookup product does not telescope"
            for r in range(usable + 1, n):
                z[r] = _prf(seed, "lk-z", p, li, r)
            data["z"] = _Poly(ops, z)
            transcript.write_point(commit_lagrange(srs, z))

    # ---- shuffle grand products ----------------------------------------
    shuffle_data = []
    for p in range(num_proofs):
        per_proof = []
        for si, argument in enumerate(cs.shuffles):
            a_comp = compress_rowwise(argument.input_expressions, p)
            s_comp = compress_rowwise(argument.shuffle_expressions, p)
            z = [0] * n
            z[0] = 1
            denoms = batch_invert(
                [(s_comp[r] + gamma) % R for r in range(usable)], R
            )
            for r in range(usable):
                z[r + 1] = z[r] * ((a_comp[r] + gamma) % R) % R * denoms[r] % R
            assert unchecked or z[usable] == 1, \
                "shuffle product does not telescope"
            for r in range(usable + 1, n):
                z[r] = _prf(seed, "sh-z", p, si, r)
            data = {"a_comp": a_comp, "s_comp": s_comp, "z": _Poly(ops, z)}
            per_proof.append(data)
            transcript.write_point(commit_lagrange(srs, z))
        shuffle_data.append(per_proof)

    # ---- vanishing: random poly, then h(X) -----------------------------
    random_values = [_prf(seed, "random", r) for r in range(n)]
    random_poly = _Poly(ops, random_values)
    transcript.write_point(commit_lagrange(srs, random_values))

    y = transcript.squeeze_challenge()

    ext_n = ops.ext_n
    ext_factor = ops.ext_factor

    def ext_rotated(poly: _Poly, rot: int):
        return _rotated(poly.ext, rot * ext_factor)

    def rowwise_ext(expr_poly, p):
        def var_array(idx):
            a_r = len(cs.advice_queries)
            f_r = a_r + len(cs.fixed_queries)
            i_r = f_r + len(cs.instance_queries)
            if idx < a_r:
                col, rot = cs.advice_queries[idx]
                return ext_rotated(advice_polys[p][col.index], rot)
            if idx < f_r:
                col, rot = cs.fixed_queries[idx - a_r]
                return ext_rotated(fixed_polys[col.index], rot)
            if idx < i_r:
                col, rot = cs.instance_queries[idx - f_r]
                return ext_rotated(instance_polys[p][col.index], rot)
            return None  # challenge: scalar

        out = [0] * ext_n
        for ci, term in expr_poly.terms:
            scalar = cs.coeff_vals[ci]
            arrays = []
            for v, pw in term:
                arr = var_array(v)
                if arr is None:
                    a_r = len(cs.advice_queries)
                    f_r = a_r + len(cs.fixed_queries)
                    i_r = f_r + len(cs.instance_queries)
                    scalar = scalar * pow(challenges[v - i_r], pw, R) % R
                else:
                    arrays.extend([arr] * pw)
            prod = [scalar] * ext_n
            for arr in arrays:
                prod = _arr_mul(prod, arr)
            out = _arr_add(out, prod)
        return out

    def compress_ext(exprs, p):
        acc = [0] * ext_n
        for e in exprs:
            acc = _arr_add(_arr_scale(acc, theta), rowwise_ext(e, p))
        return acc

    # Lagrange-basis helper polys on the extended domain
    def indicator_ext(rows):
        vals = [0] * n
        for r in rows:
            vals[r] = 1
        return _Poly(ops, vals).ext

    l0_ext = indicator_ext([0])
    llast_ext = indicator_ext([usable])
    lblind_ext = indicator_ext(range(usable + 1, n))
    active_ext = [(1 - (a + b)) % R for a, b in zip(llast_ext, lblind_ext)]
    # X on the coset extended domain
    x_ext = [0] * ext_n
    cur = domain.g_coset
    for i in range(ext_n):
        x_ext[i] = cur
        cur = cur * domain.extended_omega % R

    # fold all expressions by y in the verifier's exact order (lib.rs:273-347)
    h_ext = [0] * ext_n

    def fold(expr_arr):
        nonlocal h_ext
        h_ext = _arr_add(_arr_scale(h_ext, y), expr_arr)

    for p in range(num_proofs):
        for gate in cs.gates:
            fold(rowwise_ext(gate, p))
        # permutation expressions (permutation.rs:189-288)
        zs = perm_z_polys[p]
        if zs:
            z0 = zs[0].ext
            fold(_arr_mul(l0_ext, [(1 - v) % R for v in z0]))
            zl = zs[-1].ext
            fold(_arr_mul(llast_ext, [(v * v - v) % R for v in zl]))
        for prev, curz in zip(zs, zs[1:]):
            prev_last = _rotated(prev.ext, usable * ext_factor)
            fold(_arr_mul(l0_ext, _arr_sub(curz.ext, prev_last)))
        for ci_idx in range(len(zs)):
            cols = perm_cols[ci_idx * chunk_len: (ci_idx + 1) * chunk_len]
            sigmas = sigma_polys[ci_idx * chunk_len: (ci_idx + 1) * chunk_len]
            left = _rotated(zs[ci_idx].ext, ext_factor)
            for col, sig in zip(cols, sigmas):
                pcol_ext = {
                    "advice": lambda: advice_polys[p][col.index].ext,
                    "fixed": lambda: fixed_polys[col.index].ext,
                    "instance": lambda: instance_polys[p][col.index].ext,
                }[col.kind]()
                term = _arr_addc(
                    _arr_add(pcol_ext, _arr_scale(sig.ext, beta)), gamma
                )
                left = _arr_mul(left, term)
            right = zs[ci_idx].ext
            delta_base = pow(FR_DELTA, ci_idx * chunk_len, R)
            cur_delta = beta * delta_base % R
            for col in cols:
                pcol_ext = {
                    "advice": lambda: advice_polys[p][col.index].ext,
                    "fixed": lambda: fixed_polys[col.index].ext,
                    "instance": lambda: instance_polys[p][col.index].ext,
                }[col.kind]()
                term = _arr_addc(
                    _arr_add(pcol_ext, _arr_scale(x_ext, cur_delta)), gamma
                )
                right = _arr_mul(right, term)
                cur_delta = cur_delta * FR_DELTA % R
            fold(_arr_mul(_arr_sub(left, right), active_ext))
        # lookups (lookup.rs:159-230)
        for li, argument in enumerate(cs.lookups):
            data = lookup_data[p][li]
            z_ext = data["z"].ext
            z_next = _rotated(z_ext, ext_factor)
            ap_ext = data["a_perm"].ext
            sp_ext = data["s_perm"].ext
            ap_prev = _rotated(ap_ext, -ext_factor)
            in_ext = compress_ext(argument.input_expressions, p)
            ta_ext = compress_ext(argument.table_expressions, p)
            fold(_arr_mul(l0_ext, [(1 - v) % R for v in z_ext]))
            fold(_arr_mul(llast_ext, [(v * v - v) % R for v in z_ext]))
            left = _arr_mul(
                _arr_mul(z_next, _arr_addc(ap_ext, beta)),
                _arr_addc(sp_ext, gamma),
            )
            right = _arr_mul(
                _arr_mul(z_ext, _arr_addc(in_ext, beta)),
                _arr_addc(ta_ext, gamma),
            )
            fold(_arr_mul(_arr_sub(left, right), active_ext))
            fold(_arr_mul(l0_ext, _arr_sub(ap_ext, sp_ext)))
            fold(_arr_mul(
                _arr_mul(_arr_sub(ap_ext, sp_ext), _arr_sub(ap_ext, ap_prev)),
                active_ext,
            ))
        # shuffles (shuffle.rs:148-203)
        for si, argument in enumerate(cs.shuffles):
            data = shuffle_data[p][si]
            z_ext = data["z"].ext
            z_next = _rotated(z_ext, ext_factor)
            in_ext = compress_ext(argument.input_expressions, p)
            sh_ext = compress_ext(argument.shuffle_expressions, p)
            fold(_arr_mul(l0_ext, [(1 - v) % R for v in z_ext]))
            fold(_arr_mul(llast_ext, [(v * v - v) % R for v in z_ext]))
            left = _arr_mul(z_next, _arr_addc(sh_ext, gamma))
            right = _arr_mul(z_ext, _arr_addc(in_ext, gamma))
            fold(_arr_mul(_arr_sub(left, right), active_ext))

    h_ext = ops.divide_by_vanishing(h_ext)
    h_coeffs = ops.extended_to_coeff(h_ext)
    d = domain.get_quotient_poly_degree()
    assert unchecked or all(c == 0 for c in h_coeffs[d * n:]), (
        "quotient degree overflow: witness does not satisfy the circuit"
    )
    # unchecked: truncate the overflowing quotient — the committed h pieces
    # then cannot satisfy the verifier's h(x) opening claim
    h_pieces = [h_coeffs[i * n: (i + 1) * n] for i in range(d)]
    for piece in h_pieces:
        transcript.write_point(commit_coeff(srs, piece))

    x = transcript.squeeze_challenge()
    xn = pow(x, n, R)

    # ---- evaluations, in the verifier's exact read order ---------------
    for p in range(num_proofs):
        for col, rot in cs.advice_queries:
            transcript.write_scalar(
                advice_polys[p][col.index].eval(domain.rotate_omega(x, rot))
            )
    for col, rot in cs.fixed_queries:
        transcript.write_scalar(
            fixed_polys[col.index].eval(domain.rotate_omega(x, rot))
        )
    transcript.write_scalar(random_poly.eval(x))
    for sig in sigma_polys:
        transcript.write_scalar(sig.eval(x))
    x_next = domain.rotate_omega(x, 1)
    x_last = domain.rotate_omega(x, -(bf + 1))
    x_prev = domain.rotate_omega(x, -1)
    for p in range(num_proofs):
        zs = perm_z_polys[p]
        for i, z in enumerate(zs):
            transcript.write_scalar(z.eval(x))
            transcript.write_scalar(z.eval(x_next))
            if i + 1 < len(zs):
                transcript.write_scalar(z.eval(x_last))
    for p in range(num_proofs):
        for data in lookup_data[p]:
            transcript.write_scalar(data["z"].eval(x))
            transcript.write_scalar(data["z"].eval(x_next))
            transcript.write_scalar(data["a_perm"].eval(x))
            transcript.write_scalar(data["a_perm"].eval(x_prev))
            transcript.write_scalar(data["s_perm"].eval(x))
    for p in range(num_proofs):
        for data in shuffle_data[p]:
            transcript.write_scalar(data["z"].eval(x))
            transcript.write_scalar(data["z"].eval(x_next))

    # ---- prover queries mirroring lib.rs:349-414 -----------------------
    queries: list[ProverQuery] = []
    for p in range(num_proofs):
        for col, rot in cs.advice_queries:
            queries.append(ProverQuery(
                domain.rotate_omega(x, rot), ("advice", p, col.index),
                advice_polys[p][col.index],
            ))
        zs = perm_z_polys[p]
        for i, z in enumerate(zs):
            queries.append(ProverQuery(x, ("perm_product", p, i), z))
            queries.append(ProverQuery(x_next, ("perm_product", p, i), z))
        for i in range(len(zs) - 2, -1, -1):
            queries.append(ProverQuery(x_last, ("perm_product", p, i), zs[i]))
        for li, data in enumerate(lookup_data[p]):
            kp = ("lookup_product", p, li)
            ki = ("lookup_perm_input", p, li)
            kt = ("lookup_perm_table", p, li)
            queries.append(ProverQuery(x, kp, data["z"]))
            queries.append(ProverQuery(x, ki, data["a_perm"]))
            queries.append(ProverQuery(x, kt, data["s_perm"]))
            queries.append(ProverQuery(x_prev, ki, data["a_perm"]))
            queries.append(ProverQuery(x_next, kp, data["z"]))
        for si, data in enumerate(shuffle_data[p]):
            key = ("shuffle_product", p, si)
            queries.append(ProverQuery(x, key, data["z"]))
            queries.append(ProverQuery(x_next, key, data["z"]))
    for col, rot in cs.fixed_queries:
        queries.append(ProverQuery(
            domain.rotate_omega(x, rot), ("fixed", col.index),
            fixed_polys[col.index],
        ))
    for i, sig in enumerate(sigma_polys):
        queries.append(ProverQuery(x, ("perm_sigma", i), sig))
    # h(X) folded by x^n (vanishing.rs:102-112) and the random poly
    h_combined = [0] * n
    xn_pow = 1
    for piece in h_pieces:
        h_combined = [
            (c + xn_pow * pc) % R for c, pc in zip(h_combined, piece)
        ]
        xn_pow = xn_pow * xn % R
    queries.append(ProverQuery(x, ("h_msm", 0), _Poly(ops, coeffs=h_combined)))
    queries.append(ProverQuery(x, ("random_poly", 0), random_poly))

    if multiopen == "shplonk":
        _open_shplonk(srs, transcript, queries)
    elif multiopen == "gwc":
        _open_gwc(srs, transcript, queries)
    else:
        raise ValueError(multiopen)

    return transcript.finalize()


# --------------------------------------------------------- multiopen provers


def _group_shplonk(queries):
    """Same rotation-set grouping as the verifier (shplonk.rs:58-149)."""
    order = []
    points_of: dict = {}
    poly_of = {}
    super_points = set()
    for q in queries:
        super_points.add(q.point)
        if q.commit_key not in points_of:
            order.append(q.commit_key)
            points_of[q.commit_key] = set()
            poly_of[q.commit_key] = q.poly
        points_of[q.commit_key].add(q.point)
    set_order, set_keys = [], {}
    for key in order:
        fs = frozenset(points_of[key])
        if fs not in set_keys:
            set_order.append(fs)
            set_keys[fs] = []
        set_keys[fs].append(key)
    rotation_sets = [
        (sorted(fs), [poly_of[k] for k in set_keys[fs]]) for fs in set_order
    ]
    return rotation_sets, sorted(super_points)


def _poly_axpy(acc, scalar, coeffs):
    """acc + scalar * coeffs, growing acc as needed."""
    if len(coeffs) > len(acc):
        acc = acc + [0] * (len(coeffs) - len(acc))
    for i, c in enumerate(coeffs):
        acc[i] = (acc[i] + scalar * c) % R
    return acc


def _divide_by_roots(coeffs, roots):
    """coeffs / prod (X - root); exact by construction."""
    out = list(coeffs)
    for root in roots:
        out = poly_divide_linear(out, root)
    return out if out else [0]


def _open_shplonk(srs, transcript, queries):
    """BDFG20 opener matching verify_shplonk's algebra exactly.

    h(X)  = sum_i v^i (f_i(X) - r_i(X)) / Z_i(X)
    h2(X) = [sum_i v^i z'_i(u) (f_i(X) - r_i(u)) - Z_0(u) h(X)] / (X - u)
    with z'_i(u) = Z_{T \\ S_i}(u) / Z_{T \\ S_0}(u), the verifier's
    normalization (shplonk.rs:202-219).
    """
    rotation_sets, super_points = _group_shplonk(queries)
    y = transcript.squeeze_challenge()
    v = transcript.squeeze_challenge()

    h_poly = [0]
    power_of_v = 1
    set_data = []
    for points, polys in rotation_sets:
        f_i = [0]
        power_of_y = 1
        for poly in polys:
            f_i = _poly_axpy(f_i, power_of_y, poly.coeffs)
            power_of_y = power_of_y * y % R
        r_i = lagrange_interpolate(points, [eval_poly(f_i, pt) for pt in points])
        num = poly_sub(f_i, r_i)
        h_poly = _poly_axpy(h_poly, power_of_v, _divide_by_roots(num, points))
        set_data.append((points, f_i))
        power_of_v = power_of_v * v % R

    transcript.write_point(commit_coeff(srs, h_poly))
    u = transcript.squeeze_challenge()

    z_0 = evaluate_vanishing_polynomial(set_data[0][0], u)
    z_diff_0_inv = pow(
        evaluate_vanishing_polynomial(
            [pt for pt in super_points if pt not in set_data[0][0]], u
        ),
        -1, R,
    )

    l_poly = [0]
    power_of_v = 1
    for i, (points, f_i) in enumerate(set_data):
        if i == 0:
            z_diff_i = 1
        else:
            z_diff_i = evaluate_vanishing_polynomial(
                [pt for pt in super_points if pt not in points], u
            ) * z_diff_0_inv % R
        r_i_u = eval_poly(
            lagrange_interpolate(points, [eval_poly(f_i, pt) for pt in points]),
            u,
        )
        term = poly_sub(f_i, [r_i_u])
        l_poly = _poly_axpy(l_poly, power_of_v * z_diff_i % R, term)
        power_of_v = power_of_v * v % R
    l_poly = _poly_axpy(l_poly, -z_0 % R, h_poly)
    h2 = _divide_by_roots(l_poly, [u])
    transcript.write_point(commit_coeff(srs, h2))


def _open_gwc(srs, transcript, queries):
    """GWC19 opener: one witness W_i = commit((f_i - f_i(z_i)) / (X - z_i))
    per distinct point, f_i batched by powers of v (gwc.rs grouping)."""
    v = transcript.squeeze_challenge()
    order, grouped = [], {}
    for q in queries:
        if q.point not in grouped:
            order.append(q.point)
            grouped[q.point] = []
        grouped[q.point].append(q)
    for z in order:
        f = [0]
        power_of_v = 1
        for q in grouped[z]:
            f = _poly_axpy(f, power_of_v, q.poly.coeffs)
            power_of_v = power_of_v * v % R
        f[0] = (f[0] - eval_poly(f, z)) % R
        w = _divide_by_roots(f, [z])
        transcript.write_point(commit_coeff(srs, w))
