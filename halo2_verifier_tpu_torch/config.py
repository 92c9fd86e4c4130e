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
    mesh_shape: tuple = ()            # () = one device; a mesh is not ported
    batch_size: int = 512             # proofs per stream batch
    localize_failures: bool = True    # bisect failing batches

    def make_verifier(self, params, vk, device=None, msm=None):
        """Build the batch verifier for this configuration on `device`
        (None: the CUDA card, raising if there is none). msm: the
        BatchVerifier's MSM backend ("forest" when None; "host" for CPU
        tests)."""
        if self.mesh_shape:
            raise NotImplementedError("mesh sharding: not yet ported")
        from .parallel.orchestrator import BatchVerifier

        extra = {} if msm is None else {"msm": msm}
        return BatchVerifier(params, vk, multiopen=self.multiopen,
                             hash_name=self.hash, device=device,
                             strategy=self.strategy, pairing=self.pairing,
                             **extra)
