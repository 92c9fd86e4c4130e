"""PyTorch port, the spans a stream records
(halo2_verifier_tpu_torch/parallel/orchestrator.py's module docstring): on
the CPU, a k=8 vector_mul stream on the forest dispatch with the sqrt
pre-pass and the native VM records each span once per batch, nested where
its parent is, on the thread that runs it; a tampered batch's
localization is one span; StageTimings.stage keeps its one argument."""

import inspect
import threading
from dataclasses import dataclass, field

import pytest
import torch

from halo2_verifier_tpu_torch.ops import msm_forest
from halo2_verifier_tpu_torch.ops.constants import R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier
from halo2_verifier_tpu_torch.prover.fixtures import vm_k8_batch
from halo2_verifier_tpu_torch.utils.metrics import StageTimings

BATCHES = 2
# every span a valid stream records once per batch (per vk group where
# the batch has several); the pre-pass's three times: its gather, its
# roots' launch, its hand-off
PER_BATCH = ("device_msm_dispatch", "dispatch_plan",
             "plan_native", "plan_canonicalize", "plan_pin", "msm_wait",
             "msm_combine", "host_pairing", "finish_wait")
VM_CLASSES = ("replay_vm_hash", "replay_vm_point", "replay_vm_field")
PER_GROUP = ("decomp_wait", "host_replay", "replay_vm", "host_assemble",
             *VM_CLASSES)
CALLER = ("decomp_dispatch", "decomp_wait", "host_replay", "replay_vm",
          *VM_CLASSES,
          "host_assemble", "device_msm_dispatch", "dispatch_plan",
          "plan_native", "plan_canonicalize", "plan_pin", "finish_wait")
WORKER = ("msm_wait", "msm_combine", "host_pairing")
GONE = ("device_msm", "device_msm_collect")


@dataclass
class Spans(StageTimings):
    """A StageTimings that keeps every stage as (name, thread, t0, t1)."""
    intervals: list = field(default_factory=list, repr=False)

    def of(self, name):
        return [iv for iv in self.intervals if iv[0] == name]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: one intra-op thread
    per process keeps them from fighting the other test workers."""
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


def _verifier(params, vk, **kw):
    bv = BatchVerifier(params, vk, device="cpu", decomp=True, **kw)
    bv.timings = Spans()
    return bv


def _inside(child, parents):
    """Each `child` interval lies in a `parents` interval on its thread."""
    return all(any(tid == ptid and p0 <= t0 and t1 <= p1
                   for _n, ptid, p0, p1 in parents)
               for _c, tid, t0, t1 in child)


def _split_groups(bv):
    """Make _stream_groups hand back each batch as two groups of one
    program, as a batch of two vk groups would come."""
    real = bv._stream_groups

    def split(batch):
        groups = real(batch)
        return [(p, part) for p, idxs in groups
                for part in (idxs[:1], idxs[1:]) if part]
    bv._stream_groups = split


@pytest.mark.parametrize("groups", [1, 2])
def test_stream_records_each_span_once_per_batch(vm_k8, groups):
    """A valid stream: each span once per batch (per group), the
    pre-pass's dispatch three times (its gather, its roots' launch, its
    hand-off), replay_vm
    inside host_replay and the plan's parts inside dispatch_plan on the
    same thread, the MSM's wait and fold on a finish worker, the
    pre-pass's spans and the finish wait on the caller's thread; neither
    device_msm nor device_msm_collect."""
    params, vk, items = vm_k8
    bv = _verifier(params, vk)
    if groups == 2:
        _split_groups(bv)
    batches = [items[:2], items[1:]]
    got = [r.ok for r in bv.verify_stream(batches, pad_to=256)]
    assert got == [True] * BATCHES
    spans = bv.timings
    counts = spans.counts
    for name in PER_BATCH:
        assert counts[name] == BATCHES, name
    assert counts["decomp_dispatch"] == 3 * BATCHES
    for name in PER_GROUP:
        assert counts[name] == BATCHES * groups, name
    for name in GONE + ("localize",):
        assert name not in counts, name
    assert _inside(spans.of("replay_vm"), spans.of("host_replay"))
    for name in VM_CLASSES:
        assert _inside(spans.of(name), spans.of("replay_vm")), name
    for name in ("plan_native", "plan_canonicalize", "plan_pin"):
        assert _inside(spans.of(name), spans.of("dispatch_plan")), name
    caller = threading.get_ident()
    for name in CALLER:
        assert {tid for _n, tid, _a, _b in spans.of(name)} == {caller}, name
    for name in WORKER:
        assert caller not in {tid for _n, tid, _a, _b in spans.of(name)}, \
            name


def test_packed_dispatch_launches_the_next_pre_pass_before_its_upload(
        vm_k8):
    """On the packed forest dispatch, the next batch's roots' launch
    (its second decomp_dispatch) lies inside this batch's
    device_msm_dispatch, after its pack and before its upload and
    launch, and its hand-off (the third) follows that dispatch; the
    first batch's launch precedes every dispatch, and the verdicts
    stand."""
    params, vk, items = vm_k8
    bv = _verifier(params, vk)
    batches = [items[:2], items[1:], items[:2]]
    got = [r.ok for r in bv.verify_stream(batches, pad_to=256)]
    assert got == [True] * 3
    spans = bv.timings
    dispatches = sorted(spans.of("device_msm_dispatch"), key=lambda iv: iv[2])
    packs = sorted(spans.of("dispatch_pack"), key=lambda iv: iv[2])
    launches = sorted(spans.of("dispatch_launch"), key=lambda iv: iv[2])
    pre = sorted(spans.of("decomp_dispatch"), key=lambda iv: iv[2])
    assert len(dispatches) == len(packs) == len(launches) == 3
    assert len(pre) == 9
    inside = [iv for iv in pre if _inside([iv], dispatches)]
    assert len(inside) == 2
    for k, iv in enumerate(inside):
        assert packs[k][3] <= iv[2] and iv[3] <= launches[k][2]
        (after,) = [a for a in pre if a[2] >= iv[3]][:1]
        assert dispatches[k][3] <= after[2]
    assert pre[2][3] <= dispatches[0][2]


def test_tampered_stream_records_localize_once(vm_k8):
    """A stream whose second of three batches holds a tampered proof (the
    exact host MSM, to keep the bisection quick on the CPU): that batch's
    localization is one localize span on a finish worker, holding the
    replay it makes; the valid batches record no localization."""
    params, vk, items = vm_k8
    bv = _verifier(params, vk, msm="host")
    batches = [items[:2], [items[0], _tampered(items[1])], items[1:]]
    got = [(r.ok, r.failed_indices)
           for r in bv.verify_stream(batches, pad_to=256)]
    assert got == [(True, []), (False, [1]), (True, [])]
    spans = bv.timings
    (loc,) = spans.of("localize")
    assert loc[1] != threading.get_ident()
    inner = [iv for iv in spans.of("replay_vm")
             if iv[1] == loc[1] and loc[2] <= iv[2] and iv[3] <= loc[3]]
    assert len(inner) == 1
    assert spans.counts["replay_vm"] == 3 + len(inner)


def test_verify_bisection_is_one_localize_span(vm_k8):
    """verify() on a batch with a tampered proof: its bisection is one
    localize span; a valid batch records none."""
    params, vk, items = vm_k8
    bv = BatchVerifier(params, vk, device="cpu", msm="host")
    bv.timings = Spans()
    assert bv.verify(items[:2]).ok
    assert "localize" not in bv.timings.counts
    res = bv.verify([items[0], _tampered(items[1]), items[2]])
    assert not res.ok and res.failed_indices == [1]
    assert bv.timings.counts["localize"] == 1
    for name in GONE:
        assert name not in bv.timings.counts, name


def test_host_plan_times_its_parts_only_when_asked():
    """host_plan gives plan_native and plan_canonicalize to the timings
    it is passed, each once, and the same plan with or without them."""
    scalars = ints_to_limbs([(7 * i + 3) ** 5 % R for i in range(40)])
    spans = Spans()
    a = msm_forest.host_plan(scalars, [16, 24], timings=spans)
    b = msm_forest.host_plan(scalars, [16, 24])
    assert dict(spans.counts) == {"plan_native": 1, "plan_canonicalize": 1}
    assert a["adds"] == b["adds"] and len(a["levels"]) == len(b["levels"])


def test_replay_vm_times_the_native_call_alone(vm_k8):
    """replay_batch_raw records replay_vm once per call, inside the
    caller's own span, with its op classes inside it, and gives the same
    bytes with or without them."""
    from halo2_verifier_tpu_torch.protocol.replay_native import (
        CompiledReplay,
        vm_available,
    )

    assert vm_available()
    params, vk, items = vm_k8
    program = CompiledReplay(params, vk, tuple(len(c) for c in items[0][1]))
    spans = Spans()
    with spans.stage("outer"):
        got = program.replay_batch_raw(items, timings=spans)
    assert got == program.replay_batch_raw(items)
    assert dict(spans.counts) == {"outer": 1, "replay_vm": 1,
                                  **{name: 1 for name in VM_CLASSES}}
    assert _inside(spans.of("replay_vm"), spans.of("outer"))
    for name in VM_CLASSES:
        assert _inside(spans.of(name), spans.of("replay_vm")), name


def test_stage_keeps_one_argument():
    """StageTimings.stage(name) takes the stage's name alone, so a
    subclass that overrides it (as a harness's interval recorder does)
    keeps working."""
    t = StageTimings()
    with t.stage("x"):
        pass
    assert t.counts["x"] == 1
    params = list(inspect.signature(StageTimings.stage).parameters)
    assert params == ["self", "name"]
