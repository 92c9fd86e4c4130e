"""Tests of the benchmark harness, on the CPU:
    python -m pytest -q portbench/tests
The one test marked `cuda` runs a short cell on a card and skips here."""

import shutil
from pathlib import Path

import pytest

from portbench import cell

TINY = {"batch_sizes": [8], "cycles": 4, "tamper_every": 2,
        "warm_batches": 2, "probe": True}

# The configuration and cells whose files portbench/ keeps but that
# BENCHMARK.json does not list (PERF.md, Open questions); the tests load
# them through a spec that lists them again.
PARKED = {
    "configs": [{"name": "k9_mac_keccak_gwc", "source": "test",
                 "file": "portbench/configs/k9_mac_keccak_gwc.json",
                 "reduced": [], "why": "test"}],
    "workloads": [
        {"name": "k9_mac_keccak_gwc.stream_256", "config": "k9_mac_keccak_gwc",
         "traffic": "stream_256", "chips": 1, "why": "test"},
        {"name": "k14_mac_shplonk.tamper_1in4", "config": "k14_mac_shplonk",
         "traffic": "tamper_1in4", "chips": 1, "why": "test"},
        {"name": "k9_mac_keccak_gwc.ragged_64-1024",
         "config": "k9_mac_keccak_gwc", "traffic": "ragged_64-1024",
         "chips": 1, "why": "test"}],
}


def spec_with_parked(root=cell.ROOT) -> dict:
    """BENCHMARK.json's spec with the parked configuration and cells."""
    spec = cell.load_spec(root)
    for key, entries in PARKED.items():
        names = {e["name"] for e in spec[key]}
        spec[key] += [e for e in entries if e["name"] not in names]
    return spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test itself skips when "
        "none is present")


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-like root: a copy of portbench/ and BENCHMARK.json, the
    repository's params/ linked in, and one more cell, k9 Keccak/GWC in
    batches of 8 with every 2nd batch tampered, listed in every metric."""
    import json

    root = tmp_path / "root"
    root.mkdir()
    shutil.copytree(cell.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    (root / "params").symlink_to(cell.ROOT / "params")
    spec = spec_with_parked()
    name = "k9_mac_keccak_gwc.tiny"
    spec["workloads"].append({"name": name, "config": "k9_mac_keccak_gwc",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    for m in spec["per_layer"]:
        m.setdefault("workloads", []).append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "portbench" / "traffic" / "tiny.json").write_text(
        json.dumps(TINY))
    return Path(root)
