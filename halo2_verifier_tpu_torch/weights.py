"""The verifier's state, carried across from the reference's files.

This system has no model weights: its "weights" are the verifying key, the
KZG verifier params and the field constants (ops/field.py). Both keys are
read with this package's own copy of the reference's codecs
(protocol/vk.py, protocol/kzg.py), so bytes written by either package load
in the other.

`load_k14_mac_fixture` returns the main path's workload: the k=14
mac_range circuit (lookup, permutation, rotation gate, 32 public inputs;
shplonk, blake2b) with the 256 committed proofs of
params/k14_mac_pack.npz. The verifying key and each proof's public inputs
come from `data/k14_mac_fixture.npz`, generated once from the reference's
test prover (tests/test_torch_fixture.py holds the generator and checks
the file against a fresh derivation); the key's sha256 is checked against
the pack's at load time.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from .protocol.kzg import ParamsKZG
from .protocol.vk import PROCESSED, VerifyingKey
from .ops import hostcurve as hc

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(_PKG_DIR)
FIXTURE_PATH = os.path.join(_PKG_DIR, "data", "k14_mac_fixture.npz")
PACK_PATH = os.path.join(REPO_DIR, "params", "k14_mac_pack.npz")
SRS_K14_PATH = os.path.join(REPO_DIR, "params", "kzg_bn254_14.srs")


def params_from_reference(params_bytes: bytes, fmt: str = PROCESSED):
    """Verifier params from the reference's params codec."""
    return ParamsKZG.from_bytes(params_bytes, fmt)


def vk_from_reference(vk_bytes: bytes, fmt: str = PROCESSED):
    """Verifying key from the reference's vk codec."""
    return VerifyingKey.from_bytes(vk_bytes, fmt)


def params_from_srs(path: str):
    """Verifier params {k, g[0], g2, s_g2} from a "fat" SRS file
    (k LE u32 | n raw G1 | n raw lagrange G1 | raw g2 | raw s_g2), reading
    only the four fields the verifier needs — the counterpart of
    FullSRS.from_bytes(...).verifier_params()."""
    with open(path, "rb") as f:
        k = int.from_bytes(f.read(4), "little")
        n = 1 << k
        g0 = hc.g1_from_raw(f.read(64), check=False)
        f.seek(4 + 2 * n * 64)
        g2 = hc.g2_from_raw(f.read(128), check=False)
        s_g2 = hc.g2_from_raw(f.read(128), check=False)
    return ParamsKZG(k, n, g0, g2, s_g2)


def instances_from_array(inst_u8):
    """(n_pub, 32) uint8 little-endian scalars -> [[int, ...]] (one
    instance column)."""
    return [[int.from_bytes(bytes(row), "little") for row in inst_u8]]


def load_k14_mac_fixture(fixture_path: str = FIXTURE_PATH,
                         pack_path: str = PACK_PATH,
                         srs_path: str = SRS_K14_PATH):
    """Returns (params, vk, items) with items = [(proof_bytes, instances)]
    for the pack's 256 proofs. Raises if the stored key does not hash to
    the pack's vk_sha256."""
    with np.load(fixture_path) as fx:
        vk_bytes = fx["vk"].tobytes()
        instances = fx["instances"]
        fx_seeds = fx["seeds"]
    with np.load(pack_path) as pack:
        want = str(pack["vk_sha256"])
        proofs = pack["proofs"]
        seeds = pack["seeds"]
    got = hashlib.sha256(vk_bytes).hexdigest()
    if got != want:
        raise ValueError(f"fixture vk sha256 {got} != pack's {want}")
    if not np.array_equal(fx_seeds, seeds):
        raise ValueError("fixture seeds differ from the pack's")
    vk = vk_from_reference(vk_bytes)
    params = params_from_srs(srs_path)
    items = [
        (proofs[i].tobytes(), instances_from_array(instances[i]))
        for i in range(proofs.shape[0])
    ]
    return params, vk, items


def limbs16_to_limbs8(a):
    """Re-limb a limbs-major array of 16-bit limbs, (..., 16, B) of any
    integer type, into the 8-bit-limb format, (..., 32, B) float32: limb k
    splits into limbs 2k (low byte) and 2k + 1. The values, Montgomery
    form included, are unchanged (R = 2^256 in both formats)."""
    a = np.asarray(a).astype(np.int64)
    out = np.stack([a & 0xFF, (a >> 8) & 0xFF], axis=-2)
    return out.reshape(*a.shape[:-2], 2 * a.shape[-2],
                       a.shape[-1]).astype(np.float32)


def limbs8_to_limbs16(a):
    """Inverse of limbs16_to_limbs8: (..., 32, B) canonical 8-bit limbs
    (any numeric type) -> (..., 16, B) int32 16-bit limbs."""
    a = np.asarray(a).astype(np.int64)
    pairs = a.reshape(*a.shape[:-2], a.shape[-2] // 2, 2, a.shape[-1])
    return (pairs[..., 0, :] | (pairs[..., 1, :] << 8)).astype(np.int32)


def limbs_minor_from_reference(a, device):
    """The JAX package's limb-minor elements, a (..., 16) uint32 array of
    16-bit limbs (given as numpy), as the port's int32 tensor on
    `device` (ops/field_minor.py)."""
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)


def limbs_minor_to_reference(t):
    """Inverse of limbs_minor_from_reference: a (..., 16) int32 limb
    tensor on any device -> the reference's (..., 16) uint32 numpy
    array."""
    return t.cpu().numpy().astype(np.uint32)
