"""What decides `correct`: every answer the run was handed back is held to
the plain reference's.

An answer is a batch's BatchResult: whether the batch verifies, the
positions of the proofs that fail (when it does not) and how many proofs
it covered. The reference (reference/check.py) verifies every distinct
item that the run's batches hold; a batch's expected answer follows from
the items at its positions. Two numbers are compared, each against its
limit of 0 (the comparison is exact):

- wrong_answers: answers that differ from the reference's;
- missing_answers: batches handed over that got no answer.
"""

from __future__ import annotations

import time

from .cell import expected
from .reference.check import Reference, load_params, load_vk

LIMITS = {"wrong_answers": 0, "missing_answers": 0}


def reference_for(cfg, seed: int) -> Reference:
    return Reference(load_params(str(cfg.srs)),
                     load_vk(cfg.vk_bytes, cfg.vk_sha256),
                     cfg.multiopen, cfg.transcript, seed)


def item_verdicts(cfg, stream, keys, seed: int):
    """{key: valid} for the items `keys` of the stream, and the counts the
    metric readers take from the reference: each side's MSM terms of one
    proof and those shared by every proof, and the points one proof's
    transcript holds. The configuration's own proofs are checked as one
    group, each tampered item alone."""
    ref = reference_for(cfg, seed)
    ref.replay_items({k: stream.items[k] for k in keys})
    plain = [k for k in keys if isinstance(k, int)]
    groups = [plain] + [[k] for k in keys if not isinstance(k, int)]
    return ref.verdicts(groups), facts(ref, plain)


def facts(ref, plain) -> dict:
    a, b = (ref.duals[k] for k in plain[:2])
    out = {"points_per_proof": ref.points[plain[0]]}
    for side, (da, db) in zip(("left", "right"), zip(a, b)):
        shared = set(da[1]) & set(db[1])
        out[f"{side}_terms_per_proof"] = sum(1 for x in da[1]
                                             if x not in shared)
        out[f"{side}_terms_shared"] = len(shared)
    return out


def judge(records, batches, valid) -> dict:
    """records[i] is the BatchRecord of batches[i]; returns each compared
    number with its limit."""
    wrong = missing = 0
    for rec, batch in zip(records, batches):
        if rec.verdict is None:
            missing += 1
            continue
        ok, failed = expected(batch, valid)
        if (rec.ok, rec.num_proofs) != (ok, batch.size) or \
                (not ok and sorted(rec.failed or []) != failed):
            wrong += 1
    got = {"wrong_answers": wrong, "missing_answers": missing}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in got.items()}


def correct(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def timed_verdicts(cfg, stream, batches, seed):
    t0 = time.perf_counter()
    keys = sorted({b.key(p) for b in batches for p in range(b.size)},
                  key=lambda k: (not isinstance(k, int), str(k)))
    valid, f = item_verdicts(cfg, stream, keys, seed)
    return valid, f, time.perf_counter() - t0
