"""The comparison that decides `correct`, shown to fail: the control (the
reference without its pairing check in the program's place), and a run
driven here on the CPU (the program's host MSM in place of the card's, no
look for a card) with the timed path broken underneath, once for each
fault a one-chip cell can have."""

import pytest

from halo2_verifier_tpu_torch.parallel import orchestrator
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchResult

from portbench import cell, control, run as runmod

WL = "k9_mac_keccak_gwc.tiny"


def run_tiny(root, seed=2 ** 33 + 5):
    spec = cell.load_spec(root)
    return runmod.run_cell(spec, cell.workload(spec, WL), seed, 1.5, 0,
                           "cpu", root=root,
                           verifier_overrides={"msm": "host"},
                           out=lambda _line: None)


def test_control_is_not_correct(tiny_root):
    spec = cell.load_spec(tiny_root)
    for seed in (1, 2, 3):
        checks = control.control_checks(spec, cell.workload(spec, WL), seed,
                                        root=tiny_root)
        assert checks["wrong_answers"]["value"] > 0


def test_sound_run_is_correct(tiny_root):
    r = run_tiny(tiny_root)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks"


ORIG = orchestrator.BatchVerifier.verify_stream


def answer_altered(self, batches, **kw):
    for i, res in enumerate(ORIG(self, batches, **kw)):
        if i == 3:
            res = BatchResult(not res.ok, res.num_proofs,
                              [] if not res.ok else [0])
        yield res


def half_left_out(self, batches, **kw):
    halves = (b[:len(b) // 2] for b in batches)
    for res in ORIG(self, halves, **kw):
        yield BatchResult(res.ok, res.num_proofs * 2, res.failed_indices)


def answer_unchanged(self, batches, **kw):
    first = None
    for res in ORIG(self, batches, **kw):
        first = first or res
        yield first


def msm_unchanged(self, handle):
    last = getattr(self, "_last_points", None)
    self._last_points = points = ORIG_COLLECT(self, handle)
    return last or points


ORIG_COLLECT = orchestrator.BatchVerifier._collect_pair


@pytest.mark.parametrize("name, attr, fault", [
    ("an answer altered where it is produced", "verify_stream",
     answer_altered),
    ("half of each batch left out", "verify_stream", half_left_out),
    ("the stream's answer left unchanged", "verify_stream",
     answer_unchanged),
    ("the MSM's result left unchanged", "_collect_pair", msm_unchanged),
])
def test_fault_is_not_correct(tiny_root, monkeypatch, name, attr, fault):
    monkeypatch.setattr(orchestrator.BatchVerifier, attr, fault)
    r = run_tiny(tiny_root)
    assert not r["correct"], name
    assert r["checks"]["wrong_answers"]["value"] > 0
