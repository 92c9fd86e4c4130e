"""Runtime configuration (port of halo2_verifier_tpu/config.py): the
reference's axes — commitment scheme x multiopen verifier x transcript
hash x strategy (lib.rs:33-40), plus the SerdeFormat enum
(helpers.rs:7-19) — as one dataclass, with the same fields and
defaults."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class VerifierConfig:
    multiopen: str = "shplonk"        # "shplonk" (BDFG20) | "gwc" (GWC19)
    hash: str = "blake2b"             # "blake2b" | "keccak256"
    strategy: str = "accumulator"     # "single" | "accumulator"
    pairing: str = "host"             # "host" (C++) | "device" (ops/pairing)
    serde_format: str = "processed"   # "processed"|"raw_bytes"|"raw_bytes_unchecked"
    mesh_shape: tuple = ()            # () = one device; (D,) = D-rank MSM
    batch_size: int = 512             # proofs per stream batch
    localize_failures: bool = True    # bisect failing batches

    def make_verifier(self, params, vk, device=None, msm=None):
        """Build the batch verifier for this configuration on `device`
        (None: the CUDA card, raising if there is none). msm: the
        BatchVerifier's MSM backend ("forest" when None; "host" for CPU
        tests). mesh_shape (D,) builds parallel.mesh.make_mesh(D) on
        `device`, which needs a live process group of D ranks (D = 1: a
        world of one)."""
        from .parallel.mesh import make_mesh
        from .parallel.orchestrator import BatchVerifier

        mesh = None
        if self.mesh_shape:
            mesh = make_mesh(self.mesh_shape[0], device=device)
            device = None
        extra = {} if msm is None else {"msm": msm}
        return BatchVerifier(params, vk, multiopen=self.multiopen,
                             hash_name=self.hash, device=device, mesh=mesh,
                             strategy=self.strategy, pairing=self.pairing,
                             **extra)
