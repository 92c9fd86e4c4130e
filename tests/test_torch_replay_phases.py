"""PyTorch port, the replay VM's time by op class
(protocol/replay_native.py, native/replayvm.cpp): on the CPU, on the
k=9 Keccak256/GWC and the k=14 Blake2b/SHPLONK packs, replay_batch_raw
gives the same bytes and the same status with and without timings, and
with timings records the stages replay_vm_hash, replay_vm_point and
replay_vm_field end to end inside replay_vm, on its thread."""

import threading

import pytest

from halo2_verifier_tpu_torch import weights
from halo2_verifier_tpu_torch.ops.constants import P
from halo2_verifier_tpu_torch.protocol.replay_native import (
    OP_CLASS_STAGES,
    CompiledReplay,
    MalformedProof,
    vm_available,
)
from halo2_verifier_tpu_torch.utils.metrics import StageTimings
from portbench import cell
from portbench.record import IntervalTimings

N = 16
CONFIGS = ("k9_mac_keccak_gwc", "k14_mac_shplonk")


def _config_entry(name):
    return {"name": name, "source": "test",
            "file": f"portbench/configs/{name}.json", "reduced": [],
            "why": "test"}


@pytest.fixture(scope="module", params=CONFIGS)
def pack(request):
    """(program, the pack's first N items, their isolation weights)."""
    assert vm_available()
    spec = {"configs": [_config_entry(request.param)]}
    cfg = cell.load_config(spec, request.param)
    params = weights.params_from_srs(str(cfg.srs))
    vk = weights.vk_from_reference(cfg.vk_bytes)
    program = CompiledReplay(params, vk,
                             tuple(len(c) for c in cfg.instances[0]),
                             multiopen=cfg.multiopen,
                             hash_name=cfg.transcript)
    items = list(zip(cfg.proofs, cfg.instances))[:N]
    return program, items, [7 * i + 3 for i in range(N)]


def _ext_y(program, items):
    """The principal roots of x^3 + 3 of every proof point, as the device
    sqrt pre-pass hands them to the VM."""
    xs = program.gather_point_xs([p for p, _ in items])
    out = b""
    for row in xs:
        x = sum(int(v) << (16 * k) for k, v in enumerate(row))
        out += pow((x ** 3 + 3) % P, (P + 1) // 4, P).to_bytes(32, "little")
    return out


def _broken(items, positions):
    """The items with the first point of each proof at `positions` set to
    an x that is not on the curve's field (all ones)."""
    out = list(items)
    for i in positions:
        proof, inst = out[i]
        out[i] = (b"\xff" * 32 + proof[32:], inst)
    return out


@pytest.mark.parametrize("with_ext_y", [False, True])
def test_outputs_equal_with_and_without_timings(pack, with_ext_y):
    program, items, w = pack
    ext_y = _ext_y(program, items) if with_ext_y else None
    spans = IntervalTimings()
    got = program.replay_batch_raw(items, w, ext_y=ext_y, timings=spans)
    assert got == program.replay_batch_raw(items, w, ext_y=ext_y)
    assert got == program.replay_batch_raw(items, w)
    assert set(spans.counts) == {"replay_vm", *OP_CLASS_STAGES}


def test_op_class_stages_split_replay_vm(pack):
    """Each class once per call, each positive, together at most the
    replay_vm stage they lie in."""
    program, items, w = pack
    spans = IntervalTimings()
    for _ in range(2):
        program.replay_batch_raw(items, w, ext_y=_ext_y(program, items),
                                 timings=spans)
    for name in ("replay_vm", *OP_CLASS_STAGES):
        assert spans.counts[name] == 2, name
    parts = [spans.totals[name] for name in OP_CLASS_STAGES]
    assert all(p > 0 for p in parts)
    assert sum(parts) <= spans.totals["replay_vm"] * (1 + 1e-9)


def test_op_class_intervals_lie_inside_replay_vm(pack):
    """On a thread of its own, each class interval lies inside a replay_vm
    interval of that thread."""
    program, items, w = pack
    spans = IntervalTimings()
    t = threading.Thread(target=program.replay_batch_raw,
                         args=(items, w), kwargs={"timings": spans})
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    program.replay_batch_raw(items[:3], w[:3], timings=spans)
    vm = [iv for iv in spans.intervals if iv[0] == "replay_vm"]
    assert len({tid for _n, tid, _a, _b in vm}) == 2
    inner = [iv for iv in spans.intervals if iv[0] in OP_CLASS_STAGES]
    assert len(inner) == 6
    for _n, tid, t0, t1 in inner:
        assert any(vt == tid and v0 <= t0 <= t1 <= v1
                   for _m, vt, v0, v1 in vm)


def test_op_class_intervals_lie_end_to_end(pack):
    """In each call the three class intervals follow one another, hash,
    point, field, without overlap, from the call's start to its end."""
    program, items, w = pack
    spans = IntervalTimings()
    for _ in range(2):
        program.replay_batch_raw(items, w, timings=spans)
    vm = [iv for iv in spans.intervals if iv[0] == "replay_vm"]
    inner = [iv for iv in spans.intervals if iv[0] in OP_CLASS_STAGES]
    for _m, _vt, v0, v1 in vm:
        parts = sorted((iv for iv in inner if v0 <= iv[2] <= v1),
                       key=lambda iv: iv[2])
        assert [iv[0] for iv in parts] == list(OP_CLASS_STAGES)
        for (_n, _t, _a, b), (_n2, _t2, a2, _b2) in zip(parts, parts[1:]):
            assert a2 == pytest.approx(b, abs=1e-9)
        assert all(a <= b for _n, _t, a, b in parts)
        assert v0 <= parts[0][2] and parts[-1][3] <= v1


def test_stage_timings_keep_intervals_when_given_a_list():
    """A StageTimings given a list of intervals records each stage, add
    and add_span there, at the times its caller gives; without one it
    keeps totals alone."""
    kept = StageTimings(intervals=[])
    with kept.stage("a"):
        pass
    kept.add("b", 0.5)
    kept.add_span("c", 1.0, 1.25)
    assert [iv[0] for iv in kept.intervals] == ["a", "b", "c"]
    assert kept.intervals[2][1:] == (threading.get_ident(), 1.0, 1.25)
    name, _tid, t0, t1 = kept.intervals[1]
    assert t1 - t0 == pytest.approx(0.5)
    assert kept.totals["c"] == 0.25 and kept.counts["c"] == 1
    plain = StageTimings()
    plain.add_span("c", 1.0, 1.25)
    assert plain.intervals is None and plain.totals["c"] == 0.25


@pytest.mark.parametrize("bad", [(0,), (5,), (0, 9)])
def test_malformed_proof_reports_its_status(pack, bad):
    """A proof whose point does not decode fails at its position with
    and without timings (a sampled position, 0, and an unsampled one), and
    the call still records its stages."""
    program, items, w = pack
    broken = _broken(items, bad)
    with pytest.raises(MalformedProof) as plain:
        program.replay_batch_raw(broken, w)
    spans = IntervalTimings()
    with pytest.raises(MalformedProof) as timed:
        program.replay_batch_raw(broken, w, timings=spans)
    assert plain.value.indices == timed.value.indices == list(bad)
    for name in ("replay_vm", *OP_CLASS_STAGES):
        assert spans.counts[name] == 1, name
    assert all(spans.totals[name] >= 0 for name in OP_CLASS_STAGES)
