"""PyTorch/CUDA port of the halo2 batch verifier, for one NVIDIA H100.

A second package beside the JAX reference (halo2_verifier_tpu): plain
tensor code is PyTorch, and every Pallas kernel of the reference is a
hand-written Hopper kernel (csrc/: the Montgomery multiply and the square
root, the forest's level-0 frontier, the masked point add in two limb
formats, the doubling, the 8-bit-limb Montgomery multiply), plus the
device pairing's tower kernels (Fq add/sub, linear maps, the whole Fq12
multiply, inversion). It imports nothing of JAX or of the JAX package.

Public API (the reference's surface, halo2_verifier_tpu/__init__.py):

- verify_proof / verify_proof_single — the protocol entry point (lib.rs:33)
- VerifyingKey, ParamsKZG — bit-exact codecs for the reference formats
- SingleStrategy, AccumulatorStrategy, GuardKZG, DualMSM, MSMKZG
- Blake2bRead/Write, Keccak256Read/Write transcripts
- BatchVerifier — the streaming verifier (parallel/orchestrator.py), on
  the CUDA card unless the caller passes device="cpu"
- VerifierConfig — runtime configuration (multiopen x hash x strategy x
  pairing x serde format)
"""

from .config import VerifierConfig
from .protocol.domain import EvaluationDomain, Rotation
from .protocol.kzg import (
    AccumulatorStrategy,
    Blind,
    ConstraintSystemFailure,
    DualMSM,
    GuardKZG,
    MSMKZG,
    ParamsKZG,
    SingleStrategy,
    VerifyFailure,
)
from .protocol.verifier import verify_proof, verify_proof_single
from .protocol.vk import VerifyingKey
from .transcript import (
    Blake2bRead,
    Blake2bWrite,
    Keccak256Read,
    Keccak256Write,
)

__all__ = [
    "AccumulatorStrategy",
    "Blake2bRead",
    "Blake2bWrite",
    "Blind",
    "ConstraintSystemFailure",
    "DualMSM",
    "EvaluationDomain",
    "GuardKZG",
    "Keccak256Read",
    "Keccak256Write",
    "MSMKZG",
    "ParamsKZG",
    "Rotation",
    "SingleStrategy",
    "VerifierConfig",
    "VerifyFailure",
    "VerifyingKey",
    "verify_proof",
    "verify_proof_single",
]


def BatchVerifier(*args, **kwargs):
    """The streaming verifier (parallel/orchestrator.py), imported at first
    call: it loads torch and the MSM modules."""
    from .parallel.orchestrator import BatchVerifier as _BV

    return _BV(*args, **kwargs)
