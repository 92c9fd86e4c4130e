"""Committed proof-pack fixtures (port of
halo2_verifier_tpu/prover/fixtures.py).

Live proving with the test-only prover costs seconds per proof (k=8) to
~20 s (k=14), so test/bench workloads load pre-generated proof packs
committed under params/. A pack stores only proof bytes + witness seeds;
instances are recomputed from the seeds and vk/params re-derived from the
deterministic SRS — the vk hash in the pack catches drift.

The packs are files of the JAX package, which writes them; this loader
only reads. A pack whose vk hash, key or seeds differ from the caller's
means this package's keygen (or codecs) differ from the reference's, so it
raises instead of proving live.

Mirrors the reference's fixture discipline: deterministic SRS cached at
halo2_verifier/params/kzg_bn254_8.srs + seeded proofs
(tests/helpers.rs:87-105, tests/helpers.rs:32).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

PARAMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "..", "params")


class PackMismatch(ValueError):
    """A committed pack does not match the proving key, transcript key or
    seeds it was asked for."""


def load_pack(name: str, pk, mk, seeds, hash_name="blake2b",
              multiopen="shplonk", params_dir: str = PARAMS_DIR):
    """Return [(proof_bytes, instances)] for `seeds` from the committed
    pack <params_dir>/<name>.npz (the reference's load_or_build_pack,
    read-only). Raises PackMismatch, naming the pack, when its vk hash,
    "<hash_name>/<multiopen>" key or seed list differ from the caller's.

    mk(seed) -> assignment (with .instance); pk is the proving key.
    """
    path = os.path.join(params_dir, f"{name}.npz")
    vsha = hashlib.sha256(pk.vk.to_bytes()).hexdigest()
    key = f"{hash_name}/{multiopen}"
    with np.load(path) as z:
        got = (str(z["vk_sha256"]), str(z["key"]) if "key" in z else key,
               [int(s) for s in z["seeds"]])
        proofs = [bytes(p.tobytes()) for p in z["proofs"]]
    want = (vsha, key, [int(s) for s in seeds])
    for what, g, w in zip(("vk sha256", "key", "seeds"), got, want):
        if g != w:
            raise PackMismatch(f"pack {name} ({path}): {what} is {g}, "
                               f"expected {w}")
    return [(p, mk(s).instance) for p, s in zip(proofs, seeds)]


def vm_k8_batch(seeds=(0, 1, 2)):
    """vector_mul k=8 proof batch (the reference's primary e2e workload,
    tests/vector_mul.rs:306): returns (params, vk, [(proof, instances)])
    from the committed pack params/test_vm_k8_pack.npz."""
    from .circuits import vector_mul_spec
    from .keygen import keygen
    from .srs import load_srs

    srs = load_srs(8)
    spec, make_assignment = vector_mul_spec(8, 3)
    pk = keygen(spec, srs)

    def mk(i):
        return make_assignment([i + 2] * 3, [i + 5] * 3)

    batch = load_pack("test_vm_k8_pack", pk, mk, list(seeds))
    return srs.verifier_params(), pk.vk, batch
