"""The plain reference's verdicts on the benchmark's proofs.

Each distinct (proof, public inputs) item is replayed by the plain Python
verifier of this folder into its two KZG accumulator MSMs; a group of items
is accepted when one pairing check over a random linear combination of the
group's MSMs holds, and a group that fails is split in halves until each
failing item stands alone. A malformed proof is rejected at its replay.

Nothing here imports the program under test or takes anything it made:
the key and the SRS are read from their files with this folder's codecs,
and the key is held to the sha256 that its proof pack records.
"""

from __future__ import annotations

import hashlib
import random

from . import hostcurve as hc
from . import hostpairing as hp
from .constants import R
from .kzg import DualMSM, ParamsKZG, VerifyFailure
from .transcript import TRANSCRIPT_READERS
from .verifier import verify_proof
from .vk import VerifyingKey


def load_params(srs_path: str) -> ParamsKZG:
    """Verifier params {k, g[0], g2, s_g2} from a "fat" SRS file
    (k LE u32 | n raw G1 | n raw lagrange G1 | raw g2 | raw s_g2)."""
    with open(srs_path, "rb") as f:
        k = int.from_bytes(f.read(4), "little")
        n = 1 << k
        g0 = hc.g1_from_raw(f.read(64), check=False)
        f.seek(4 + 2 * n * 64)
        g2 = hc.g2_from_raw(f.read(128), check=False)
        s_g2 = hc.g2_from_raw(f.read(128), check=False)
    return ParamsKZG(k, n, g0, g2, s_g2)


def load_vk(vk_bytes: bytes, want_sha256: str) -> VerifyingKey:
    got = hashlib.sha256(vk_bytes).hexdigest()
    if got != want_sha256:
        raise ValueError(f"verifying key sha256 {got} is not the pack's "
                         f"{want_sha256}")
    return VerifyingKey.from_bytes(vk_bytes)


class _Capture:
    """A strategy that keeps the accumulator verify_proof hands it."""

    def __init__(self, params):
        self.params = params
        self.dual = None

    def process(self, f):
        self.dual = f(DualMSM(self.params))
        return self.dual


def _counting(reader):
    """The transcript reader, counting the points it reads."""

    class Counting(reader):
        points = 0

        def read_point(self):
            self.points += 1
            return super().read_point()

    return Counting


READERS = {name: _counting(r) for name, r in TRANSCRIPT_READERS.items()}


def replay(params, vk, proof: bytes, instances, multiopen: str,
           transcript: str):
    """One proof's (left, right) MSMs as ([scalars], [bases]) pairs, or None
    for a proof the transcript replay rejects; and the points its
    transcript held."""
    cap = _Capture(params)
    reader = READERS[transcript](proof)
    try:
        verify_proof(params, vk, cap, [instances], reader,
                     multiopen=multiopen)
    except (VerifyFailure, ValueError, EOFError):
        return None, reader.points
    d = cap.dual
    return ((list(d.left.scalars), list(d.left.bases)),
            (list(d.right.scalars), list(d.right.bases))), reader.points


def _combined(msms, weights):
    """sum_i w_i * msm_i, terms that share a base merged."""
    acc = {}
    for (scalars, bases), w in zip(msms, weights):
        for s, b in zip(scalars, bases):
            acc[b] = (acc.get(b, 0) + s * w) % R
    bases = list(acc)
    return hc.g1_msm([acc[b] for b in bases], bases)


def _pairing_holds(params, duals, rng) -> bool:
    weights = [1 + rng.randrange(R - 1) for _ in duals]
    left = _combined([d[0] for d in duals], weights)
    right = _combined([d[1] for d in duals], weights)
    return hp.pairing_check([(left, params.s_g2),
                             (right, hc.g2_neg(params.g2))])


class Reference:
    """Verdicts of the plain verifier on one configuration's items."""

    def __init__(self, params, vk, multiopen: str, transcript: str,
                 seed: int):
        self.params = params
        self.vk = vk
        self.multiopen = multiopen
        self.transcript = transcript
        self._rng = random.Random(seed)
        self.duals = {}
        self.points = {}

    def replay_items(self, items) -> None:
        """items: {key: (proof, instances)}; replays those not seen yet."""
        for key, (proof, instances) in items.items():
            if key not in self.duals:
                self.duals[key], self.points[key] = replay(
                    self.params, self.vk, proof, instances, self.multiopen,
                    self.transcript)

    def verdicts(self, groups) -> dict:
        """groups: lists of keys already replayed; returns {key: valid}.
        How the keys are grouped changes only the cost: a group that fails
        its check is split until every failing key stands alone."""
        out = {}
        for group in groups:
            keys = [k for k in group if self.duals[k] is not None]
            out.update((k, False) for k in group if self.duals[k] is None)
            self._settle(keys, out)
        return out

    def _settle(self, keys, out) -> None:
        if not keys:
            return
        if _pairing_holds(self.params, [self.duals[k] for k in keys],
                          self._rng):
            out.update((k, True) for k in keys)
            return
        if len(keys) == 1:
            out[keys[0]] = False
            return
        mid = len(keys) // 2
        self._settle(keys[:mid], out)
        self._settle(keys[mid:], out)
