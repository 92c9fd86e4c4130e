"""The mesh and the sharded MSMs on torch.distributed (port of
halo2_verifier_tpu/parallel/mesh.py).

One rank per device: a mesh of D devices is a process group of D ranks,
each running the same program on its own device (SPMD replay: every rank
replays every proof on the host, so every rank holds the whole MSM on
the host). Each rank runs its shard of the MSM with the package's
kernels; the collectives below move only what must cross ranks.

Sharded kinds, as the reference's orchestrator picks them:
- windows (sharded_forest_by_windows), when D divides NUM_WINDOWS: rank d
  plans and runs the forest over windows [d*W/D, (d+1)*W/D) of every
  group across all points. The point table is uploaded 1/D per rank and
  all-gathered (upload="shard"), or uploaded whole (upload="replicate").
- forest (sharded_forest_window_totals), when D divides the total window
  count: rank d runs the forest over its slice of each group's points,
  scatters its partial bucket grid, and one all_to_all over the window
  axis hands rank d every rank's partials for its tw/D windows, which it
  tree-reduces in the reference's halving order (so the projective
  representatives are the reference's, bit for bit) and reduces.
- scan (sharded_window_totals_presorted), else: the host-sorted entries
  split evenly across ranks, the points replicate; a bucket segment cut
  at a rank boundary gives two partial sums that add exactly.
Every kind ends with one all_gather of the per-rank window totals, so
every rank folds the same (D, 3, nlimbs, ·) totals on the host.

The collectives run on the transport device of the backend: CUDA tensors
for NCCL, CPU tensors for gloo (whose collectives take CPU tensors). That
move is transport only: the kernels run on the rank's device either way.
A world of one without a group needs no collective.

Not ported, by design: the reference's _pad_plans_uniform and its staged
shard_map cache (_forest_stages) exist because one SPMD XLA program must
have the same shapes on every chip. Each rank here launches its own
kernels eagerly, so its plan keeps its own shapes; only the tensors that
cross ranks must match, and they do by construction (the point table's
columns, the (3, nlimbs, tw/D * 256) grid chunks, the window totals).
The padding adds identity lanes only beyond the real ones and sends its
entries to the dropped dump slot, so each rank's window totals equal the
reference's per-chip totals without it.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops import curve, msm_scan
from ..ops import msm_forest as mf
from ..ops.field import I64
from ..ops.limbs import NLIMBS
from ..ops.msm import (NUM_BUCKETS, NUM_WINDOWS, combine_window_totals,
                       combine_window_totals_grouped)
from ..utils.device import resolve_device
from . import dist as h2v_dist

UPLOADS = ("shard", "replicate")
# point adds of the bucket phase per window: a 7-level tree over 128
# buckets for each of 8 bit planes, then a 14-step Horner
BUCKET_ADDS_PER_WINDOW = 127 * 8 + 14


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `size` ranks of one process group, this process being
    `rank` and driving `device`. No group_ref: a world of one, no
    collective.

    The mesh refers to its group weakly, so that dist.shutdown() destroys
    the group, and with it joins the backend's worker threads, however
    many meshes and verifiers are still alive: a gloo worker still
    releasing a finished collective's tensors when the interpreter
    finalizes aborts the process (std::terminate at exit)."""

    size: int
    rank: int
    device: torch.device
    backend: str | None = None
    group_ref: weakref.ref | None = None

    @property
    def group(self):
        """The process group, None for a world of one; raises once the
        group has been shut down."""
        if self.group_ref is None:
            return None
        group = self.group_ref()
        if group is None:
            raise RuntimeError("the mesh's process group has been shut "
                               "down (parallel.dist.shutdown)")
        return group

    @property
    def spans_processes(self) -> bool:
        return self.group_ref is not None and self.size > 1


def same_device(a: torch.device, b: torch.device) -> bool:
    """a and b name one device ("cuda" matches "cuda:0")."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _launch_hint(n) -> str:
    return (f"a mesh of {n} devices needs a live process group of {n} "
            f"ranks, one per device: start {n} processes with `torchrun "
            f"--nproc-per-node={n} ...`, or with H2V_COORDINATOR=host:port, "
            f"H2V_NUM_PROCESSES={n} and H2V_PROCESS_ID=0..{n - 1}, and call "
            "parallel.dist.init_distributed() in each")


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh over the live process group (which must have n_devices
    ranks), or, with no group live and n_devices None or 1, a world of one
    on `device` (None: CUDA, raising if absent)."""
    if not h2v_dist.is_multiprocess():
        if n_devices not in (None, 1):
            raise RuntimeError(_launch_hint(n_devices))
        return Mesh(1, 0, resolve_device(device))
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise RuntimeError(f"the live process group has {world} ranks; "
                           + _launch_hint(n_devices))
    dev = h2v_dist.group_device()
    if dev is None:  # a group formed without init_distributed
        dev = resolve_device(device)
    elif device is not None and not same_device(resolve_device(device), dev):
        raise ValueError(f"this rank drives {dev}, not {device}")
    return Mesh(world, dist.get_rank(), dev, dist.get_backend(),
                weakref.ref(dist.group.WORLD))


# --------------------------------------------------------- collectives

def _transport(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t where the backend moves it: CUDA for NCCL, the CPU for gloo."""
    if mesh.backend == "nccl":
        return t.contiguous()
    return t.to("cpu").contiguous()


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(D, *t.shape), rank d's t at [d], on the transport device."""
    if mesh.group is None:
        return t.unsqueeze(0)
    src = _transport(mesh, t)
    # the concatenated form: gloo takes no stacked output
    out = src.new_empty((mesh.size * src.shape[0], *src.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor  # the name before torch 2.13
    gather(out, src, group=mesh.group)
    return out.view(mesh.size, *src.shape)


def all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t's leading axis (of length D): [j] goes to rank j; the result's
    [s] came from rank s. On the transport device."""
    if mesh.group is None:
        return t
    src = _transport(mesh, t)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank src's t, on every rank, on the transport device."""
    if mesh.group is None:
        return t
    buf = _transport(mesh, t).clone()
    dist.broadcast(buf, src=src, group=mesh.group)
    return buf


def _rank_sum(mesh: Mesh, n: int) -> int:
    """n summed over the ranks: one tiny all_gather, which every rank
    must make at the same point."""
    t = torch.tensor([n], dtype=torch.int64, device=mesh.device)
    return int(all_gather(mesh, t).sum())


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    return np.asarray(arr)


# ------------------------------------------------- plain sharded scan

def sharded_window_totals(mesh: Mesh, scalars, xs, ys):
    """Per-rank window totals with the entries sharded over the ranks
    (msm_scan.window_totals_impl on each slice). The entry count must be
    a multiple of the mesh size (pad_entries). Returns 3 (D, NLIMBS, W)
    tensors; combine with combine_sharded."""
    n = scalars.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} entries do not split over {mesh.size} ranks "
                         "(pad_entries)")
    c = n // mesh.size
    sl = slice(mesh.rank * c, (mesh.rank + 1) * c)
    wt = msm_scan.window_totals_impl(scalars[sl], xs[sl], ys[sl],
                                     mesh.device)
    g = all_gather(mesh, torch.stack(wt))
    return tuple(g[:, k] for k in range(3))


def combine_sharded(parts):
    """(D, NLIMBS, W) triple -> host affine point: per-rank window totals
    summed per window, then Horner-folded, in exact host arithmetic."""
    arrs = [_host(c) for c in parts]
    return combine_window_totals([tuple(a[d] for a in arrs)
                                  for d in range(arrs[0].shape[0])])


def sharded_msm(mesh: Mesh, scalars, xs, ys):
    """Full sharded MSM -> host affine point (x, y) or None."""
    return combine_sharded(sharded_window_totals(mesh, scalars, xs, ys))


def pad_entries(scalars, xs, ys, multiple: int):
    """Pad (n, NLIMBS) entry arrays to a multiple of the mesh size with
    zero scalars, which contribute nothing."""
    n = scalars.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return scalars, xs, ys
    pad = np.zeros((rem, NLIMBS), dtype=scalars.dtype)
    return tuple(np.concatenate([a, pad]) for a in (scalars, xs, ys))


# ------------------------------------------------ grouped presorted scan

def sharded_window_totals_presorted(mesh: Mesh, xs, ys, idx_sorted,
                                    keys_sorted, total_windows: int,
                                    levels: int, backend: str | None = None):
    """Sharded grouped scan MSM: the host-sorted (idx, key) entries split
    evenly across the ranks (their count a multiple of D), the points
    replicate. Returns the (D, 3, nlimbs, total_windows) per-rank totals
    on every rank; combine with combine_sharded_grouped.

    xs/ys: (n, NLIMBS) canonical affine limbs; backend: "u16" (K1 + K2)
    or "f8" (K4 + K5), default "u16"."""
    backend = backend or msm_scan.DEFAULT_BACKEND
    m = idx_sorted.shape[0]
    if m % mesh.size:
        raise ValueError(f"{m} sorted entries do not split over {mesh.size} "
                         "ranks (pad with identity entries)")
    msm_scan.check_plan(xs.shape[0], idx_sorted, keys_sorted, total_windows)
    c = m // mesh.size
    sl = slice(mesh.rank * c, (mesh.rank + 1) * c)
    keys = keys_sorted[sl]
    dev = mesh.device
    wt = msm_scan.window_totals_presorted_impl(
        msm_scan._to_device(xs, dev), msm_scan._to_device(ys, dev),
        msm_scan._to_device(idx_sorted[sl], dev, I64),
        msm_scan._to_device(keys, dev), total_windows, levels,
        bucket_pos=msm_scan._to_device(
            msm_scan.segment_ends(keys, total_windows), dev),
        backend=backend)
    return all_gather(mesh, wt)


def combine_sharded_grouped(arr, groups: int):
    """(D, 3, nlimbs, g*W) -> list of g host affine points: per-rank
    window totals summed per window, then Horner-folded."""
    arr_np = _host(arr)
    out = []
    for gi in range(groups):
        sl = slice(gi * NUM_WINDOWS, (gi + 1) * NUM_WINDOWS)
        out.append(combine_window_totals([
            tuple(arr_np[d][c][:, sl] for c in range(3))
            for d in range(arr_np.shape[0])
        ]))
    return out


# ------------------------------------------------ point-sharded forest

def _add_stacks(a, b):
    """a + b lane by lane for (h, 3, NLIMBS, L) stacks of points: one
    point-add launch over h * L lanes."""
    h, _, nl, lanes = a.shape

    def flat(x):
        f = x.permute(1, 2, 0, 3).reshape(3, nl, h * lanes)
        return tuple(f[c].contiguous() for c in range(3))

    s = torch.stack(curve.add(flat(a), flat(b)))
    return s.reshape(3, nl, h, lanes).permute(2, 0, 1, 3).contiguous()


def sharded_forest_window_totals(mesh: Mesh, x_np, y_np, s_np, sizes,
                                 stats: dict | None = None):
    """Forest MSM with the points sharded over the ranks; returns the
    (D, 3, NLIMBS, tw/D) window totals on every rank, rank d's windows
    being [d*tw/D, (d+1)*tw/D). Combine with combine_sharded_forest.

    stats (optional dict): the wire accounting (host->device upload bytes
    in all, summed over the ranks' plans by one tiny all_gather, and this
    rank's; the bucket grid's all_to_all bytes per rank; the totals' bytes
    per rank; host plan seconds) and this rank's device point adds. Every
    rank passes stats or none."""
    t_plan0 = time.time()
    D, d = mesh.size, mesh.rank
    tw = len(sizes) * NUM_WINDOWS
    if tw % D:
        raise ValueError(f"mesh size {D} does not divide the {tw} windows")
    offs = np.cumsum([0] + list(sizes))
    sl_sizes, rows = [], []
    for g, sz in enumerate(sizes):
        lo = offs[g] + (sz * d) // D
        hi = offs[g] + (sz * (d + 1)) // D
        sl_sizes.append(int(hi - lo))
        rows.append(np.arange(lo, hi))
    rows = np.concatenate(rows)
    plan = mf.host_plan(np.ascontiguousarray(s_np[rows]), sl_sizes)
    mf._check_plan(plan)
    xs, ys = mf._pad_transpose_points(x_np[rows], y_np[rows], plan["n_pad"])
    twd = tw // D
    lanes = twd * NUM_BUCKETS
    if stats is not None:
        upload = int(xs.nbytes + ys.nbytes + _index_bytes(plan))
        stats.update(
            plan_seconds=round(time.time() - t_plan0, 6),
            upload_bytes=_rank_sum(mesh, upload),
            upload_bytes_per_chip=upload,
            collective_bytes_per_chip=int(3 * NLIMBS * tw * NUM_BUCKETS * 4),
            fetch_bytes_per_chip=int(3 * NLIMBS * twd * 4),
            # forest levels, the D - 1 partial grids added in, the planes
            point_adds=int(plan["adds"] + (D - 1) * lanes
                           + twd * BUCKET_ADDS_PER_WINDOW),
        )
    dev = mesh.device
    fin, scatter = mf.forest_buckets(mf._upload(xs.view(np.int32), dev),
                                     mf._upload(ys.view(np.int32), dev), plan)
    grid = mf._bucket_grid(fin, scatter, tw)
    # rank j receives columns [j*lanes, (j+1)*lanes) of every rank's grid
    send = (torch.stack(grid).reshape(3, NLIMBS, D, lanes)
            .permute(2, 0, 1, 3).contiguous())
    red = all_to_all(mesh, send).to(dev)  # [s]: rank s's partial grid
    # the reference's halving order: first half + second half, the odd
    # partial carried to the next round
    while red.shape[0] > 1:
        half = red.shape[0] // 2
        s = _add_stacks(red[:half], red[half:2 * half])
        if red.shape[0] & 1:
            s = torch.cat([s, red[2 * half:]])
        red = s
    totals = mf.plane_reduce(tuple(c.contiguous() for c in red[0]), twd)
    return all_gather(mesh, totals)


def _index_bytes(plan) -> int:
    """Bytes of one rank's forest gather and scatter indices."""
    return 4 * (plan["point_idx0"].shape[0]
                + 2 * sum(iL.shape[0] for iL, _iR in plan["levels"])
                + 2 * sum(pos.shape[0] for _l, pos, _k in plan["finished"]))


def combine_sharded_forest(arr, groups: int):
    """(D, 3, NLIMBS, tw/D) -> per-group host affine points: rank d owns
    the global windows [d*tw/D, (d+1)*tw/D), so the rank axis
    concatenates back into window order."""
    arr_np = _host(arr)
    full = np.concatenate(list(arr_np), axis=2)  # (3, NLIMBS, tw)
    return combine_window_totals_grouped(full, groups)


# ---------------------------------------------- window-sharded forest

def sharded_forest_by_windows(mesh: Mesh, x_np, y_np, s_np, sizes,
                              stats: dict | None = None,
                              upload: str = "shard"):
    """Window-sharded forest MSM: rank d plans and runs windows
    [d*W/D, (d+1)*W/D) of every group over all points. Returns the
    (D, 3, NLIMBS, groups*W/D) window totals on every rank; combine with
    combine_sharded_windows.

    upload: "shard" (each rank uploads 1/D of the point table and one
    all_gather rebuilds it on the device; taken when D divides the padded
    table) or "replicate" (each rank uploads the whole table).
    stats (optional dict): the wire accounting, as the reference keeps it
    (upload bytes in all, summed over the ranks' plans by one tiny
    all_gather, and this rank's; the all_gather's bytes per rank; the
    totals' bytes per rank; host plan seconds), and this rank's device
    point adds. Every rank passes stats or none."""
    if upload not in UPLOADS:
        raise ValueError(f"unknown upload {upload!r} (expected one of "
                         f"{UPLOADS})")
    t_plan0 = time.time()
    D, d = mesh.size, mesh.rank
    if NUM_WINDOWS % D:
        raise ValueError(f"mesh size {D} does not divide the {NUM_WINDOWS} "
                         "windows")
    wpc = NUM_WINDOWS // D
    plan = mf.host_plan(s_np, sizes, window_lo=d * wpc, window_count=wpc)
    mf._check_plan(plan)
    n_pad = plan["n_pad"]  # the same points, the same padding everywhere
    xs, ys = mf._pad_transpose_points(x_np, y_np, n_pad)
    table = np.stack([xs, ys]).view(np.int32)  # (2, NLIMBS, n_pad)
    shard = upload == "shard" and n_pad % D == 0
    if stats is not None:
        table_bytes = int(table.nbytes)
        upload = int((table_bytes // D if shard else table_bytes)
                     + _index_bytes(plan))
        stats.update(
            plan_seconds=round(time.time() - t_plan0, 6),
            upload_bytes=_rank_sum(mesh, upload),
            upload_bytes_per_chip=upload,
            collective_bytes_per_chip=int(
                table_bytes * (D - 1) // D if shard else 0),
            fetch_bytes_per_chip=int(3 * NLIMBS * plan["tw"] * 4),
            point_adds=int(plan["adds"]
                           + plan["tw"] * BUCKET_ADDS_PER_WINDOW),
        )
    dev = mesh.device
    if shard:
        cols = n_pad // D
        part = mf._upload(table[:, :, d * cols:(d + 1) * cols], dev)
        g = all_gather(mesh, part).to(dev)  # (D, 2, NLIMBS, cols)
        table_t = g.permute(1, 2, 0, 3).reshape(2, NLIMBS, n_pad)
    else:
        table_t = mf._upload(table, dev)
    fin, scatter = mf.forest_buckets(table_t[0].contiguous(),
                                     table_t[1].contiguous(), plan)
    return all_gather(mesh, mf._bucket_phase(fin, scatter, plan["tw"]))


def windows_in_order(arr, groups: int) -> np.ndarray:
    """(D, 3, nlimbs, groups*wpc) per-rank window totals -> the
    (3, nlimbs, groups*W) totals in window order, as the single-device
    forest lays them out: rank d's local window g*wpc + j is global
    window d*wpc + j of group g."""
    arr_np = _host(arr)
    D = arr_np.shape[0]
    wpc = arr_np.shape[3] // groups
    if wpc * D != NUM_WINDOWS:
        raise ValueError(f"{D} ranks of {wpc} windows do not cover "
                         f"{NUM_WINDOWS}")
    return np.concatenate([arr_np[r][:, :, g * wpc:(g + 1) * wpc]
                           for g in range(groups) for r in range(D)], axis=2)


def combine_sharded_windows(arr, groups: int):
    """(D, 3, NLIMBS, groups*wpc) per-rank window totals -> per-group host
    affine points."""
    return combine_window_totals_grouped(windows_in_order(arr, groups),
                                         groups)
