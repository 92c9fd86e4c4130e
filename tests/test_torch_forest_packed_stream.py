"""PyTorch port, the orchestrator's forest dispatch
(halo2_verifier_tpu_torch/parallel/orchestrator.py through
msm_forest.dispatch_planned): on the CPU a stream of k=8 vector_mul
batches gives the expected verdicts and the localized index of a tampered
batch; plan widths are pinned per workload, the pin's pad adds counted;
the dispatch's parts are timed."""

import ast

import pytest
import torch

from halo2_verifier_tpu_torch.ops.constants import R
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier
from halo2_verifier_tpu_torch.prover.fixtures import vm_k8_batch

TAMPERED = 1  # the tampered proof's index in its batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vm_k8():
    return vm_k8_batch(seeds=(0, 1, 2))


def _tampered(item):
    proof, inst = item
    return proof, [[(inst[0][0] + 1) % R] + inst[0][1:]]


def test_stream_verdicts(vm_k8):
    """Two good batches, then one with its second proof's public input
    changed: ok, ok, and a failure localized at that index."""
    params, vk, items = vm_k8
    batches = [items[:2], items[1:], [items[0], _tampered(items[1])]]
    bv = BatchVerifier(params, vk, device="cpu")
    got = [(r.ok, r.failed_indices) for r in bv.verify_stream(batches)]
    assert got == [(True, []), (True, []), (False, [TAMPERED])]
    # the bisection pins its own workload: both sides at the stream's pad
    pad = max(ast.literal_eval(k)[0] for k in bv._plan_pins)
    assert repr((pad, pad)) in bv._plan_pins
    assert bv.forest_recordings.recorded == 0  # no recording off CUDA
    parts = {"dispatch_plan", "dispatch_check", "dispatch_pack",
             "dispatch_launch", "dispatch_prefetch"}
    counts = bv.timings.counts
    assert parts <= set(counts)
    # the stream's three dispatches; the bisection's are not split
    assert all(counts[p] == 3 for p in parts)
    assert counts["device_msm_dispatch"] == 3


def test_pins_pad_the_plan_and_count_its_adds(vm_k8, monkeypatch):
    """Each stream batch's plan is pinned at its workload's widths before
    it is dispatched, under the workload's pin key; point_adds_dispatched
    counts the pinned plan's adds, identity pad adds included; a pin that
    the batch outgrows is a re-pin."""
    from halo2_verifier_tpu_torch.ops import msm_forest

    params, vk, items = vm_k8
    seen = []
    real_pin = msm_forest.pin_plan_widths

    def pin(plan, pinned=None):
        natural = plan["adds"]
        plan, new = real_pin(plan, pinned)
        seen.append((pinned, new, natural, plan["adds"]))
        return plan, new

    slots = []
    real_dispatch = msm_forest.dispatch_planned

    def dispatch(*args, **kw):
        slots.append(kw["slot"])
        return real_dispatch(*args, **kw)

    monkeypatch.setattr(msm_forest, "pin_plan_widths", pin)
    monkeypatch.setattr(msm_forest, "dispatch_planned", dispatch)
    bv = BatchVerifier(params, vk, device="cpu")
    key = repr((256, 256))

    def run():
        before = bv.point_adds_dispatched
        (res,) = bv.verify_stream([items[:2]], pad_to=256)
        assert res.ok
        return bv.point_adds_dispatched - before

    run()  # the workload's first batch sets its pin
    assert seen[0][0] is None and bv._plan_pins[key] == seen[0][1]
    assert bv.plan_repins == 0 and slots == [key]
    first = seen[0][1]
    wide = (tuple(w + 256 for w in first[0]),
            tuple(w + 256 for w in first[1]))
    bv._plan_pins[key] = wide
    adds = run()
    pinned, new, natural, pinned_adds = seen[1]
    assert pinned == new == wide and bv.plan_repins == 0
    assert pinned_adds == natural + 256 * (len(wide[0]) - 1)
    assert adds == pinned_adds + 2 * 32 * (127 * 8 + 14)
    narrow = (first[0][:1] + (1,) * (len(first[0]) - 1), first[1])
    bv._plan_pins[key] = narrow
    run()
    assert bv.plan_repins == 1 and bv._plan_pins[key] == first
