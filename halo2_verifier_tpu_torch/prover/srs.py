"""SRS loading / generation for the test-only prover.

Parses the upstream "fat" SRS byte format (k LE u32 | n raw G1 | n raw
lagrange G1 | raw g2 | raw s_g2) produced by the reference's gen_srs
(tests/helpers.rs:87-105); the k=8 fixture shipped with the reference is
used directly. For other k a deterministic test-only SRS is generated
(toxic waste derived from a fixed seed, mirroring ParamsKZG::setup's
"MUST NOT be used in production" caveat, kzg/commitment.rs:54-112).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

from ..ops import hostcurve as hc
from ..ops.constants import FR_ROOT_OF_UNITY, FR_S, G1_GEN, G2_GEN, R
from ..protocol.kzg import ParamsKZG

# The upstream reference ships a deterministic k=8 fixture; the file named
# by H2V_REFERENCE_SRS_K8 (its halo2_verifier/params/kzg_bn254_8.srs) is
# read when present, for cross-implementation validation. Never copied into
# this repo — regenerated deterministically when absent.
REFERENCE_SRS_K8 = os.environ.get("H2V_REFERENCE_SRS_K8", "")


@dataclass
class FullSRS:
    k: int
    g: list          # monomial basis [s^i]G1
    g_lagrange: list  # [L_i(s)]G1
    g2: tuple
    s_g2: tuple

    def verifier_params(self) -> ParamsKZG:
        """The space-efficient verifier params (convert_params,
        serialize/src/lib.rs:26-36)."""
        return ParamsKZG(self.k, 1 << self.k, self.g[0], self.g2, self.s_g2)

    # upstream fat codec ----------------------------------------------------
    def to_bytes(self) -> bytes:
        out = bytearray(int(self.k).to_bytes(4, "little"))
        for p in self.g:
            out += hc.g1_to_raw(p)
        for p in self.g_lagrange:
            out += hc.g1_to_raw(p)
        out += hc.g2_to_raw(self.g2)
        out += hc.g2_to_raw(self.s_g2)
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "FullSRS":
        k = int.from_bytes(data[:4], "little")
        n = 1 << k
        off = 4
        g = []
        for _ in range(n):
            g.append(hc.g1_from_raw(data[off: off + 64], check=False))
            off += 64
        g_lagrange = []
        for _ in range(n):
            g_lagrange.append(hc.g1_from_raw(data[off: off + 64], check=False))
            off += 64
        g2 = hc.g2_from_raw(data[off: off + 128], check=False)
        off += 128
        s_g2 = hc.g2_from_raw(data[off: off + 128], check=False)
        return cls(k, g, g_lagrange, g2, s_g2)


def _jacobian_scale_chain(base, scalars):
    """[scalars[i]] * base for many scalars, with a shared 4-bit window
    table and one batched final normalization."""
    table = [None] * 16  # table[d] = d * base, Jacobian
    table[1] = hc.j_from_affine(base)
    for d in range(2, 16):
        table[d] = hc.j_add(table[d - 1], table[1])
    out = []
    for s in scalars:
        k = s % R
        acc = hc.J_IDENTITY
        for shift in range(252, -4, -4):
            if acc != hc.J_IDENTITY:
                for _ in range(4):
                    acc = hc.j_double(acc)
            d = (k >> max(shift, 0)) & 0xF if shift >= 0 else 0
            if shift >= 0 and d:
                acc = hc.j_add(acc, table[d])
        out.append(acc)
    return hc.batch_normalize(out)


def generate_srs(k: int, seed: bytes = b"halo2-verifier-tpu-test-srs") -> FullSRS:
    """Deterministic test SRS; lagrange bases via the closed form
    L_i(s) = (s^n - 1)/n * omega^i / (s - omega^i) (kzg/commitment.rs:84-100)."""
    n = 1 << k
    s = int.from_bytes(hashlib.blake2b(seed + bytes([k])).digest(), "little") % R
    powers = [1] * n
    for i in range(1, n):
        powers[i] = powers[i - 1] * s % R
    g = _jacobian_scale_chain(G1_GEN, powers)

    root = FR_ROOT_OF_UNITY
    for _ in range(k, FR_S):
        root = root * root % R
    n_inv = pow(n, -1, R)
    multiplier = (pow(s, n, R) - 1) * n_inv % R
    from ..ops.hostfield import batch_invert
    root_pows = [1] * n
    for i in range(1, n):
        root_pows[i] = root_pows[i - 1] * root % R
    denoms = batch_invert([(s - rp) % R for rp in root_pows], R)
    lag_scalars = [multiplier * rp % R * d % R for rp, d in zip(root_pows, denoms)]
    g_lagrange = _jacobian_scale_chain(G1_GEN, lag_scalars)

    g2 = G2_GEN
    s_g2 = hc.g2_mul(G2_GEN, s)
    return FullSRS(k, g, g_lagrange, g2, s_g2)


_SRS_CACHE: dict[int, FullSRS] = {}


def load_srs(k: int, cache_dir: str | None = None) -> FullSRS:
    """Load the reference k=8 fixture, a cached file, or generate (and
    cache under params/)."""
    if k in _SRS_CACHE:
        return _SRS_CACHE[k]
    candidates = []
    if k == 8 and os.path.exists(REFERENCE_SRS_K8):
        candidates.append(REFERENCE_SRS_K8)
    if cache_dir:
        candidates.append(os.path.join(cache_dir, f"kzg_bn254_{k}.srs"))
    candidates.append(
        os.path.join(os.path.dirname(__file__), "..", "..", "params",
                     f"kzg_bn254_{k}.srs")
    )
    # a file of another size is absent here, or still being written
    # (the JAX package's load_srs writes the shared cache in place)
    size = 4 + 2 * (1 << k) * 64 + 2 * 128
    srs = None
    for path in candidates:
        if os.path.exists(path) and os.path.getsize(path) == size:
            with open(path, "rb") as f:
                srs = FullSRS.from_bytes(f.read())
            break
    if srs is None:
        srs = generate_srs(k)
        path = candidates[-1]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # other processes may read the same cache file (the JAX package's
        # load_srs writes the same bytes there): publish it whole
        tmp = f"{path[:-len('.srs')]}.{os.getpid()}.tmp.srs"
        with open(tmp, "wb") as f:
            f.write(srs.to_bytes())
        os.replace(tmp, path)
    _SRS_CACHE[k] = srs
    return srs
