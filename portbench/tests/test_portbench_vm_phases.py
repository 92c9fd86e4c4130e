"""The readers of the replay VM's op classes (replay_vm_hash_ms,
replay_vm_point_ms, replay_vm_field_ms) on synthetic runs, and their
entries in BENCHMARK.json."""

import pytest

from portbench import cell, run as runmod
from portbench.record import BatchRecord, Run

CLASSES = ("hash", "point", "field")
CELLS = ["k14_mac_shplonk.stream_1024", "k9_mac_keccak_gwc.stream_256"]
MAIN, OTHER = 1, 2


def reader(name):
    return runmod.load_reader(cell.ROOT, name)


def synthetic(stages, handed=(0.5, 1.5, 2.5, 3.5), t_start=0.0,
              t_end=10.0):
    batches = [BatchRecord(256, (), False, h, h + 1.0, True, [], 256)
               for h in handed]
    return Run("w", "c", "t", t_end - t_start, 1.0, t_start, t_end, batches,
               {}, {}, {}, stages, None)


def vm_call(t0, t1, shares, tid=MAIN):
    """One replay_vm interval and its op classes as the program records
    them: each class's part of the call, ending where the call's timed
    part ends."""
    out = [("replay_vm", tid, t0, t1)]
    for c, s in zip(CLASSES, shares):
        out.append((f"replay_vm_{c}", tid, t1 - s * (t1 - t0), t1))
    return out


def test_readers_give_ms_per_batch():
    stages = (vm_call(1.0, 1.4, (0.25, 0.25, 0.5))
              + vm_call(2.0, 2.2, (0.5, 0.1, 0.4))
              # a second thread's replay counts too
              + vm_call(3.0, 3.1, (0.2, 0.3, 0.5), tid=OTHER)
              # past the window's end: clipped to it
              + vm_call(9.8, 10.2, (1.0, 0.0, 0.0)))
    r = synthetic(stages)
    want = {"hash": 0.1 + 0.1 + 0.02 + 0.2,
            "point": 0.1 + 0.02 + 0.03,
            "field": 0.2 + 0.08 + 0.05}
    for c in CLASSES:
        assert reader(f"replay_vm_{c}_ms")(r) == \
            pytest.approx(want[c] * 1e3 / 4), c
    total = sum(reader(f"replay_vm_{c}_ms")(r) for c in CLASSES)
    assert total == pytest.approx(reader("replay_vm_ms")(r))


@pytest.mark.parametrize("c", CLASSES)
def test_reader_reads_nothing_without_its_stage(c):
    """None on an untraced run, on a run that handed over no batch in the
    window, and on a program that records replay_vm alone (the parent's)."""
    read = reader(f"replay_vm_{c}_ms")
    assert read(synthetic(None)) is None
    full = vm_call(1.0, 2.0, (0.3, 0.3, 0.4))
    assert read(synthetic(full, handed=(11.0,))) is None
    assert read(synthetic(full)) is not None
    parent = [("host_replay", MAIN, 0.9, 2.1), ("replay_vm", MAIN, 1.0, 2.0)]
    assert read(synthetic(parent)) is None


@pytest.mark.parametrize("c", CLASSES)
def test_vm_class_metrics_are_listed_for_both_cells(c):
    spec = cell.load_spec()
    (m,) = [m for m in spec["per_layer"] if m["name"] == f"replay_vm_{c}_ms"]
    assert (m["source"], m["unit"], m["better"]) == \
        ("program_span", "ms", "lower")
    assert m["layer"] == "replay VM"
    assert m["moves"] == "device_us_per_proof"
    assert m["workloads"] == CELLS
    for name in CELLS:
        assert m in cell.metric_entries(spec, name, "per_layer")


def test_k9_cell_is_in_the_benchmark():
    spec = cell.load_spec()
    wl = cell.workload(spec, "k9_mac_keccak_gwc.stream_256")
    assert (wl["config"], wl["traffic"], wl["chips"]) == \
        ("k9_mac_keccak_gwc", "stream_256", 1)
    cfg = cell.load_config(spec, wl["config"])
    assert (cfg.multiopen, cfg.transcript) == ("gwc", "keccak256")
    assert cell.config_entry(spec, wl["config"])["reduced"] == []
