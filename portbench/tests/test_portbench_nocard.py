"""Without a card the run fails and prints no result; so it does in a
directory holding only BENCHMARK.json and the benchmark's folder."""

import shutil
import subprocess
import sys

import pytest

from portbench import cell


def run_cell_cmd(cwd, workload="k14_mac_shplonk.stream_1024"):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = run_cell_cmd(cell.ROOT)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(cell.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(cell.ROOT / "BENCHMARK.json", tmp_path)
    p = run_cell_cmd(tmp_path)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = run_cell_cmd(cell.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"device_us_per_proof", "setup_s"}
