"""Multi-process group bring-up on torch.distributed (port of
halo2_verifier_tpu/parallel/dist.py).

One rank per device. Every rank replays every proof on the host (SPMD
replay) and runs its shard of the MSM on its own device; only window
totals, and for the point-sharded forest the bucket grid, cross ranks
(parallel/mesh.py). Where the reference's jax.distributed group makes one
global device list, here the group itself is the mesh: D ranks, D devices.

Environment-driven bring-up, every rank started with the same command:

    H2V_COORDINATOR=host0:12345 H2V_NUM_PROCESSES=4 H2V_PROCESS_ID=k ...

or torchrun's variables (`torchrun --nproc-per-node=D ...` sets
MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK).

The backend is an argument: "nccl" by default for a CUDA device, "gloo"
for the CPU. A group that fails to form raises; nothing switches backend
or device behind the caller's back. Several ranks may share one card with
"gloo" (NCCL refuses two ranks on one GPU): their kernels run on the card
and their collectives pass through host memory.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DEFAULT_TIMEOUT_S = 300.0

# the device init_distributed bound this rank to (None: no group formed
# here); read by mesh.make_mesh
_rank_device = None


def is_multiprocess() -> bool:
    """True once a process group is live."""
    return dist.is_available() and dist.is_initialized()


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v else None


def rank_device(device=None, local_device_ids=None) -> torch.device:
    """This rank's device: the CPU when asked for; else
    cuda:{local_device_ids[0]}, or cuda:{LOCAL_RANK % device_count}, so
    that several ranks of a one-card host all get cuda:0."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_device_ids is not None:
        if len(local_device_ids) != 1:
            raise ValueError("one rank drives one device: local_device_ids "
                             f"must name one, got {list(local_device_ids)}")
        return torch.device("cuda", int(local_device_ids[0]))
    local = _env_int("LOCAL_RANK") or 0
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, backend: str | None = None,
                     device=None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join (or form) the process group. Idempotent.

    Resolution order per field: explicit argument > H2V_COORDINATOR /
    H2V_NUM_PROCESSES / H2V_PROCESS_ID / H2V_LOCAL_DEVICE_IDS > torchrun's
    MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK. Returns True if a group is
    live after the call, False when no coordinator is configured (one
    process: every single-device path works without this).

    device: None (CUDA, raising if absent) or "cpu" for CPU ranks.
    backend: None = "nccl" for a CUDA device, "gloo" for the CPU.
    timeout: seconds for the rendezvous and for each collective."""
    global _rank_device
    if is_multiprocess():
        return True
    coordinator = coordinator or os.environ.get("H2V_COORDINATOR")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = _env_int("H2V_NUM_PROCESSES")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("H2V_PROCESS_ID")
    if process_id is None:
        process_id = _env_int("RANK")
    if local_device_ids is None:
        ids = os.environ.get("H2V_LOCAL_DEVICE_IDS")
        local_device_ids = [int(i) for i in ids.split(",")] if ids else None
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator} is set but the world "
                         "size or this process's rank is not: set "
                         "H2V_NUM_PROCESSES and H2V_PROCESS_ID (or "
                         "WORLD_SIZE and RANK)")
    dev = rank_device(device, local_device_ids)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected 'nccl' or 'gloo')")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs a CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("backend 'nccl' is not available in this "
                               "torch build")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    _rank_device = dev
    return True


def shutdown() -> None:
    global _rank_device
    if is_multiprocess():
        dist.destroy_process_group()
    _rank_device = None


def process_info() -> tuple[int, int]:
    """(rank, world size) of the live group; (0, 1) without one."""
    if not is_multiprocess():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def group_device():
    """The device init_distributed bound this rank to, or None."""
    return _rank_device


def make_global_mesh(n_devices: int | None = None):
    """The mesh over the live group (one device per rank), as
    mesh.make_mesh builds it; drop-in for make_mesh on multi-host
    deployments."""
    from .mesh import make_mesh

    return make_mesh(n_devices)
