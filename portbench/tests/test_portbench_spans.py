"""The readers of the program's host-path spans (portbench/spans.py and
the metrics built on it) on synthetic runs."""

import pytest

from portbench import cell, run as runmod, spans
from portbench.record import BatchRecord, Run

SPAN_READERS = ("replay_vm_ms", "replay_marshal_ms", "decomp_dispatch_ms",
                "decomp_wait_ms", "plan_native_ms", "plan_canonicalize_ms",
                "plan_pin_ms", "msm_wait_ms", "msm_combine_ms",
                "finish_wait_ms", "main_unstaged_ms")
MAIN, WORKER = 1, 2


def reader(name):
    return runmod.load_reader(cell.ROOT, name)


def synthetic(stages, handed=(0.5, 1.5, 2.5, 3.5), t_start=0.0,
              t_end=10.0):
    batches = [BatchRecord(100, (), False, h, h + 1.0, True, [], 100)
               for h in handed]
    return Run("w", "c", "t", t_end - t_start, 1.0, t_start, t_end, batches,
               {}, {}, {}, stages, None)


def test_union_clips_and_merges():
    got = spans.union([(3.0, 4.0), (-1.0, 1.0), (0.5, 2.0), (9.0, 12.0),
                       (11.0, 13.0)], 0.0, 10.0)
    assert got == [[0.0, 2.0], [3.0, 4.0], [9.0, 10.0]]
    assert spans.covered(got, 1.0, 3.5) == pytest.approx(1.5)


def test_self_time_less_nested_and_overlapping_children():
    stages = [
        ("host_replay", MAIN, 1.0, 5.0),
        # overlapping children: their union, 1.5 .. 3.0, counts once
        ("replay_vm", MAIN, 1.5, 2.5), ("replay_vm", MAIN, 2.0, 3.0),
        # a child nested in a child adds nothing
        ("replay_vm", MAIN, 2.2, 2.4),
        # a child reaching past its parent subtracts only its inside part
        ("replay_vm", MAIN, 4.5, 6.0),
        # a child on another thread subtracts nothing
        ("replay_vm", WORKER, 1.0, 5.0),
        # a parent clipped by the window
        ("host_replay", MAIN, 9.0, 11.0), ("replay_vm", MAIN, 9.5, 10.5),
    ]
    r = synthetic(stages)
    assert spans.self_seconds(r, "host_replay", ("replay_vm",)) == \
        pytest.approx((4.0 - 1.5 - 0.5) + (1.0 - 0.5))
    assert reader("replay_marshal_ms")(r) == pytest.approx(2500.0 / 4)


def test_vm_and_marshal_sum_to_the_replay():
    stages = [("host_replay", MAIN, 0.2, 1.2), ("replay_vm", MAIN, 0.4, 1.0),
              ("host_replay", MAIN, 2.0, 2.9), ("replay_vm", MAIN, 2.1, 2.8),
              ("host_replay", MAIN, 9.8, 10.4),
              ("replay_vm", MAIN, 9.9, 10.3)]
    r = synthetic(stages)
    assert reader("replay_vm_ms")(r) + reader("replay_marshal_ms")(r) == \
        pytest.approx(reader("host_replay_ms")(r))


def test_main_unstaged_is_the_main_threads_uncovered_window():
    stages = [
        # the main thread: replay, then a dispatch that overlaps a plan
        ("host_replay", MAIN, -1.0, 2.0), ("replay_vm", MAIN, 0.5, 1.5),
        ("device_msm_dispatch", MAIN, 3.0, 4.0),
        ("dispatch_plan", MAIN, 3.5, 4.5), ("finish_wait", MAIN, 9.0, 11.0),
        # another thread's stages leave the main thread's gaps open
        ("host_pairing", WORKER, 2.0, 3.0), ("msm_wait", WORKER, 4.5, 9.0),
        ("host_replay", WORKER, 5.0, 5.5),
    ]
    r = synthetic(stages)
    assert spans.main_thread(r) == MAIN
    # covered 0 .. 2, 3 .. 4.5, 9 .. 10: 4.5 of the 10 s window
    assert reader("main_unstaged_ms")(r) == pytest.approx(5500.0 / 4)
    assert reader("main_unstaged_ms")(synthetic([])) is None


def test_stage_readers_clip_to_the_window_per_batch():
    stages = [("msm_wait", WORKER, -1.0, 1.0), ("msm_wait", WORKER, 2.0, 2.5),
              ("plan_pin", MAIN, 9.5, 10.5), ("finish_wait", MAIN, 11.0, 12.0)]
    r = synthetic(stages)
    assert reader("msm_wait_ms")(r) == pytest.approx(1500.0 / 4)
    assert reader("plan_pin_ms")(r) == pytest.approx(500.0 / 4)
    # recorded, but only outside the window: zero, not missing
    assert reader("finish_wait_ms")(r) == 0.0


@pytest.mark.parametrize("name", SPAN_READERS)
def test_reader_reads_nothing_without_its_spans(name):
    """None on an untraced run, on a run that handed over no batch in
    the window, and on a program without the new spans (the parent's:
    host_replay and the rest, none of this reader's own)."""
    assert reader(name)(synthetic(None)) is None
    full = [(n, MAIN, 1.0, 2.0) for n in
            ("host_replay", "replay_vm", "decomp_dispatch", "decomp_wait",
             "plan_native", "plan_canonicalize", "plan_pin", "msm_wait",
             "msm_combine", "finish_wait")]
    assert reader(name)(synthetic(full, handed=(11.0,))) is None
    assert reader(name)(synthetic(full)) is not None
    if name != "main_unstaged_ms":
        parent = [("host_replay", MAIN, 1.0, 2.0),
                  ("device_msm_dispatch", MAIN, 2.0, 3.0),
                  ("dispatch_plan", MAIN, 2.0, 2.5),
                  ("device_msm_collect", WORKER, 3.0, 4.0)]
        assert reader(name)(synthetic(parent)) is None


def test_span_metrics_are_listed_for_the_stream_cell():
    spec = cell.load_spec()
    listed = {m["name"]: m for m in spec["per_layer"]}
    layers = {m["layer"] for m in spec["per_layer"]
              if m["name"] not in SPAN_READERS}
    for name in SPAN_READERS:
        m = listed[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["moves"] == "device_us_per_proof"
        assert m["workloads"] == ["k14_mac_shplonk.stream_1024"]
        assert m["layer"] in layers
