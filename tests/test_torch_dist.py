"""PyTorch port, process-group bring-up (halo2_verifier_tpu_torch/parallel/
dist.py) and the mesh's collectives (parallel/mesh.py), mirroring
tests/test_multihost.py: no configuration forms no group; a 2-rank gloo
group formed from the H2V_* variables or from torchrun's runs all_gather,
all_to_all_single and broadcast, raw and through the mesh helpers; the
backend never switches silently; VerifierConfig(mesh_shape=(D,)) builds
the mesh and raises when no group of D ranks is live; shutdown destroys
the group (its worker threads joined) while a mesh is still alive, and
every rank exits 0, group after group."""

import pytest
import torch

from halo2_verifier_tpu_torch import VerifierConfig
from halo2_verifier_tpu_torch.parallel import dist, mesh as pmesh

from torch_ranks import GROUP_VARS, run_ranks

WORKER = r"""
import json, os, sys
import torch
import torch.distributed as tdist
from halo2_verifier_tpu_torch import VerifierConfig
from halo2_verifier_tpu_torch.parallel import dist
from halo2_verifier_tpu_torch.parallel import mesh as pmesh

assert not dist.is_multiprocess()
assert dist.init_distributed(device="cpu", timeout=60)
assert dist.init_distributed(device="cpu")  # idempotent
rank, n = dist.process_info()
assert n == 2 and dist.is_multiprocess()
assert tdist.get_backend() == "gloo"
mesh = dist.make_global_mesh()
assert (mesh.size, mesh.rank, mesh.device.type, mesh.backend) == (
    2, rank, "cpu", "gloo") and mesh.spans_processes

# raw collectives on int32/int64 CPU tensors
x = torch.arange(6, dtype=torch.int32).reshape(3, 2) + 100 * rank
gathered = torch.empty((6, 2), dtype=torch.int32)
tdist.all_gather_into_tensor(gathered, x)
a2a = torch.empty(4, dtype=torch.int64)
tdist.all_to_all_single(a2a, torch.arange(4, dtype=torch.int64) + 10 * rank)
b = torch.tensor([7 + rank], dtype=torch.int64)
tdist.broadcast(b, src=1)

# the mesh helpers
g = pmesh.all_gather(mesh, x)
t = pmesh.all_to_all(mesh, torch.stack([x, -x]))
s = pmesh.broadcast(mesh, torch.tensor([rank + 5], dtype=torch.int64))

bv = VerifierConfig(mesh_shape=(2,)).make_verifier(None, None, device="cpu",
                                                  msm="host")
try:
    VerifierConfig(mesh_shape=(3,)).make_verifier(None, None, device="cpu")
    wrong = "built"
except RuntimeError as e:
    wrong = str(e)
with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as f:
    json.dump({"gathered": gathered.tolist(), "a2a": a2a.tolist(),
               "b": b.tolist(), "g": g.tolist(), "t": t.tolist(),
               "s": s.tolist(), "bv_mesh": [bv.mesh.size, bv.mesh.rank],
               "bv_device": str(bv.device), "wrong": wrong}, f)
dist.shutdown()
assert not dist.is_multiprocess()
print(f"DIST_OK rank={rank}", flush=True)
"""


STEADY_EXIT_WORKER = r"""
import sys, weakref
import torch
import torch.distributed as tdist
from halo2_verifier_tpu_torch.parallel import dist
from halo2_verifier_tpu_torch.parallel import mesh as pmesh

assert dist.init_distributed(device="cpu", timeout=60)
rank, _n = dist.process_info()
mesh = pmesh.make_mesh(2, device="cpu")
assert pmesh.all_gather(mesh, torch.tensor([rank + 1])).flatten().tolist() \
    == [1, 2]
group = weakref.ref(tdist.group.WORLD)
dist.shutdown()
dist.shutdown()  # idempotent
assert group() is None, "the process group outlived shutdown"
try:
    mesh.group
    sys.exit("a shut-down mesh still hands out its group")
except RuntimeError:
    pass
print(f"EXIT_OK rank={rank}", flush=True)
"""


def _clear_group_env(monkeypatch):
    for var in GROUP_VARS:
        monkeypatch.delenv(var, raising=False)


def test_single_process_mode_is_default(monkeypatch):
    """No H2V_* and no torchrun variables: init is a no-op, returns False
    and forms no group (tests/test_multihost.py
    test_single_host_mode_is_default)."""
    _clear_group_env(monkeypatch)
    assert dist.init_distributed(device="cpu") is False
    assert not dist.is_multiprocess()
    assert dist.process_info() == (0, 1)


@pytest.mark.parametrize("style", ["h2v", "torchrun"])
def test_two_rank_group_collectives(tmp_path, style):
    """A 2-rank gloo group from the environment alone: all_gather,
    all_to_all_single and broadcast raw and through the mesh helpers,
    make_global_mesh, and VerifierConfig(mesh_shape=...) on it."""
    import json

    outs = run_ranks(WORKER, 2, tmp_path, timeout=120, style=style)
    for r, out in enumerate(outs):
        assert f"DIST_OK rank={r}" in out, out
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    x = [[[i * 2 + j + 100 * r for j in range(2)] for i in range(3)]
         for r in range(2)]
    for r, got in enumerate(res):
        assert got["gathered"] == x[0] + x[1]
        assert got["a2a"] == [2 * r, 2 * r + 1, 10 + 2 * r, 11 + 2 * r]
        assert got["b"] == [8]
        assert got["g"] == x
        neg = [[[-v for v in row] for row in m] for m in x]
        assert got["t"] == ([x[0], x[1]] if r == 0 else [neg[0], neg[1]])
        assert got["s"] == [5]
        assert got["bv_mesh"] == [2, r] and got["bv_device"] == "cpu"
        assert "3 ranks" in got["wrong"] and "has 2 ranks" in got["wrong"]


def test_group_exits_cleanly_three_times(tmp_path):
    """A 2-rank gloo group formed three times in a row: one collective,
    shutdown, exit. shutdown destroys the group though a mesh still
    refers to it (its gloo worker threads are joined before the
    interpreter finalizes; a worker left finishing a collective at exit
    aborted the rank), and every rank exits 0."""
    for k in range(3):
        work = tmp_path / f"group{k}"
        work.mkdir()
        outs = run_ranks(STEADY_EXIT_WORKER, 2, work, timeout=60)
        for r, out in enumerate(outs):
            assert f"EXIT_OK rank={r}" in out, out


def test_backend_never_switches(monkeypatch):
    """backend="nccl" on a CPU device, or where NCCL is missing, raises
    before any rendezvous; an unknown backend raises; a coordinator with
    no world size or rank raises. No group is left behind."""
    _clear_group_env(monkeypatch)
    args = dict(coordinator="127.0.0.1:1", num_processes=1, process_id=0)
    with pytest.raises(ValueError, match="CUDA device"):
        dist.init_distributed(**args, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        dist.init_distributed(**args, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="world size"):
        dist.init_distributed(coordinator="127.0.0.1:1", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.init_distributed(**args)  # CUDA by default: absent here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        dist.init_distributed(**args)  # nccl, the CUDA default
    assert not dist.is_multiprocess()


def test_rank_device(monkeypatch):
    """One rank, one device: cuda:{local_device_ids[0]}, else
    cuda:{LOCAL_RANK % device_count} (four ranks of a one-card host all
    on cuda:0); the CPU when asked for."""
    _clear_group_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for local in range(4):
        monkeypatch.setenv("LOCAL_RANK", str(local))
        assert dist.rank_device() == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dist.rank_device() == torch.device("cuda", 3)
    assert dist.rank_device(local_device_ids=[2]) == torch.device("cuda", 2)
    assert dist.rank_device("cuda:1") == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="one rank drives one device"):
        dist.rank_device(local_device_ids=[0, 1])
    assert dist.rank_device("cpu") == torch.device("cpu")


def test_make_mesh_world_of_one_and_launch_hint(monkeypatch):
    """Without a group, make_mesh(None or 1) is a world of one on the
    given device, with no collective; a mesh of D > 1 raises and says how
    to launch D ranks."""
    _clear_group_env(monkeypatch)
    for n in (None, 1):
        m = pmesh.make_mesh(n, device="cpu")
        assert (m.size, m.rank, m.device, m.group, m.spans_processes) == (
            1, 0, torch.device("cpu"), None, False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node=4"):
        pmesh.make_mesh(4, device="cpu")
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert torch.equal(pmesh.all_gather(m, t), t[None])
    assert torch.equal(pmesh.all_to_all(m, t), t)
    assert torch.equal(pmesh.broadcast(m, t), t)


def test_verifier_config_mesh_shape(monkeypatch):
    """mesh_shape=(1,) builds a world of one on the given device;
    mesh_shape=(D,) with no group of D ranks live raises."""
    _clear_group_env(monkeypatch)
    bv = VerifierConfig(mesh_shape=(1,)).make_verifier(None, None,
                                                      device="cpu",
                                                      msm="host")
    assert bv.mesh.size == 1 and bv.device == torch.device("cpu")
    assert not bv.decomp
    with pytest.raises(RuntimeError, match="2 ranks"):
        VerifierConfig(mesh_shape=(2,)).make_verifier(None, None,
                                                      device="cpu")
