"""A configuration, a traffic mix and a metric added as files (and as
entries of BENCHMARK.json) are found by name, with no code edited."""

import json

from portbench import cell, run as runmod


def test_new_files_are_found_by_name(tiny_root):
    root = tiny_root
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench" / "configs" /
                      "k9_mac_keccak_gwc.json").read_text())
    cfg["name"] = "k9_copy"
    (root / "portbench" / "configs" / "k9_copy.json").write_text(
        json.dumps(cfg))
    (root / "portbench" / "traffic" / "two_sizes.json").write_text(
        json.dumps({"batch_sizes": [16, 32], "shuffle": True, "cycles": 2}))
    (root / "portbench" / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return float(len(run.batches))\n")
    spec["configs"].append({"name": "k9_copy", "source": "test",
                            "file": "portbench/configs/k9_copy.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "k9_copy.two_sizes",
                              "config": "k9_copy", "traffic": "two_sizes",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "batches_seen", "unit": "batches",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "device_us_per_proof",
                              "workloads": ["k9_copy.two_sizes"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    spec = cell.load_spec(root)
    wl = cell.workload(spec, "k9_copy.two_sizes")
    c = cell.load_config(spec, wl["config"], root)
    assert c.name == "k9_copy" and len(c.proofs) == 16
    t = cell.load_traffic(wl["traffic"], root)
    s = cell.build_stream(c, t, 5)
    assert sorted(b.size for b in s.cycle) == [16, 16, 32, 32]
    names = [m["name"] for m in cell.metric_entries(spec, wl["name"],
                                                    "per_layer")]
    assert "batches_seen" in names and "host_replay_ms" not in names
    read = runmod.load_reader(root, "batches_seen")

    class R:
        batches = [1, 2, 3]

    assert read(R) == 3.0


def test_unknown_names_are_refused(tiny_root):
    import pytest

    spec = cell.load_spec(tiny_root)
    with pytest.raises(cell.SpecError):
        cell.workload(spec, "nope.nothing")
    with pytest.raises(cell.SpecError):
        cell.load_traffic("nothing", tiny_root)
    with pytest.raises(cell.SpecError):
        runmod.load_reader(tiny_root, "nothing")
    (tiny_root / "portbench" / "traffic" / "bad.json").write_text(
        '{"batch_sizes": [8], "batchsize": 3}')
    with pytest.raises(cell.SpecError):
        cell.load_traffic("bad", tiny_root)


def test_inputs_that_are_not_the_recorded_ones_are_refused(tiny_root):
    import pytest

    from portbench.tests.conftest import spec_with_parked

    spec = spec_with_parked(tiny_root)
    path = tiny_root / "portbench" / "configs" / "k9_mac_keccak_gwc.json"
    good = json.loads(path.read_text())
    assert cell.load_config(spec, "k9_mac_keccak_gwc", tiny_root).proofs
    for key in ("proofs_sha256", "inputs_sha256"):
        bad = dict(good, **{key: "0" * 64})
        path.write_text(json.dumps(bad))
        with pytest.raises(cell.SpecError, match="sha256"):
            cell.load_config(spec, "k9_mac_keccak_gwc", tiny_root)
