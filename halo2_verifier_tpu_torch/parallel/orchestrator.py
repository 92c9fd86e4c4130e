"""Batch-verification orchestrator on one device or a mesh (port of
halo2_verifier_tpu/parallel/orchestrator.py: BatchVerifier, BatchResult).

Pipeline:
1. DEVICE, one batch ahead: the sqrt pre-pass (ops/decomp.py) computes
   the principal root of every compressed proof point. Its x-coordinates
   are gathered before the batch before is replayed; its kernel is
   launched in that batch's packed forest dispatch, between the pack and
   the upload of the MSM's operands, so that the upload runs on the card
   beside the square roots.
2. HOST, per proof: transcript replay on the native VM, with the isolation
   weights folded in, assembling the two accumulator MSMs as limb arrays.
3. DEVICE: both MSMs as one host-planned addition forest
   (ops/msm_forest.py) or, with msm="scan", one host-sorted segmented
   scan (ops/msm_scan.py), giving a (3, nlimbs, 64) window-totals tensor.
   The forest's plan widths are pinned per workload; its dispatch packs
   every operand into one upload and, on CUDA, replays the chain recorded
   for the pinned signature (msm_forest.dispatch_planned).
4. HOST: exact combine of the window totals and one pairing per batch
   (the native host pairing, or with pairing="device" the tower of
   ops/pairing.py on the verifier's device); on failure, bisection over
   the replayed per-proof MSMs.

All device work runs on the current stream of one device, but for the
forest's upload, on a copy stream of its own. Results come
back through a non-blocking copy into pinned host memory and a recorded
CUDA event: the finish workers wait on that event, never on the device,
and only read their own buffer.

With a mesh (parallel/mesh.py) every rank runs this same program on its
own device (SPMD replay): the same proofs, the same isolation weights
(from a seed rank 0 broadcasts), and its shard of the MSM, whose sharded
kind falls through windows -> point-sharded forest -> presorted scan by
the mesh size, as the reference's does. Every collective is issued from
the dispatching thread, in stream order on every rank: the stream keeps
one finish worker, and a failing batch is localized on that thread.

Spans: the stages `timings` (utils/metrics.StageTimings) gets from a
stream. On the thread that consumes verify_stream: decomp_dispatch
three times a batch (the pre-pass's gather and staging, one batch
ahead; the upload and the roots' launch, inside the batch before's
device_msm_dispatch on the forest; the D2H enqueue and hand-off
after that dispatch),
decomp_wait (the block on its roots), host_replay (with replay_vm, the
native VM call, inside it; the rest is the staging around it; inside
replay_vm, replay_vm_hash, replay_vm_point and replay_vm_field, the call
split by the op-class shares the VM timed on a sample of its proofs and
laid end to end: apportioned, not observed),
host_assemble, device_msm_dispatch (with dispatch_plan, inside it
plan_native, plan_canonicalize and plan_pin, then msm_forest's dispatch_*
parts and dispatch_prefetch) and finish_wait (the block on the oldest
batch's finish). On a finish worker: msm_wait (the wait for the window
totals' copy), msm_combine (their exact host fold) and <pairing>_pairing.
localize times the whole of a failing batch's localization, wherever it
runs, and holds its own replay, MSM and pairing stages; it is an
operator's span: what finding a bad proof costs.
"""

from __future__ import annotations

import random
import secrets
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import msm_forest, msm_scan
from ..ops import hostcurve as hc
from ..ops.constants import R
from ..ops.decomp import launch_y_batch, stage_x_batch
from ..ops.limbs import ints_to_limbs, limbs_to_ints
from ..ops.msm import NUM_WINDOWS, combine_window_totals_grouped
from ..protocol.kzg import DualMSM, VerifyFailure, pairing_backend
from ..protocol.verifier import verify_proof
from ..transcript import TRANSCRIPT_READERS
from ..utils.device import resolve_device
from ..utils.metrics import StageTimings, maybe_stage
from . import mesh as pmesh


def _dedup_entries(entries):
    """Merge MSM entries sharing a base point: sum their scalars mod R.
    First-appearance order; identity-base (None) entries merge too."""
    idx = {}
    out = []
    for s, b in entries:
        j = idx.get(b)
        if j is None:
            idx[b] = len(out)
            out.append([s % R, b])
        else:
            out[j][0] = (out[j][0] + s) % R
    return [(s, b) for s, b in out]


class _PendingDecomp:
    """A stream batch's sqrt pre-pass, its x-coordinates gathered and
    staged on the host (per vk group; None where a group has no points),
    launched later in two steps, each once: launch_roots(beside) queues
    their upload and the roots' kernel, with `beside` (a
    kernels.HostCopy: the packed forest's upload) queued by the first
    kernel's own call, and returns whether it queued it; hand_off() (after
    launch_roots() where that has not run) queues the roots' D2H and
    hands their fetch and pack to the stream's decomp worker. result(g)
    hands off where that has not happened and gives group g's ext_y
    bytes."""

    def __init__(self, verifier, xs, counts, executor):
        self.verifier = verifier
        self.xs = xs
        self.counts = counts
        self.executor = executor
        self.ys = None
        self.futures = None

    def launch_roots(self, beside=None):
        if self.ys is not None or self.futures is not None:
            return False
        bv = self.verifier
        queued = False
        with bv.timings.stage("decomp_dispatch"):
            self.ys = []
            for xs in self.xs:
                if xs is None:
                    self.ys.append(None)
                    continue
                self.ys.append(launch_y_batch(
                    xs, bv.device, None if queued else beside))
                queued = beside is not None
            bv.decomp_points_dispatched += sum(self.counts)
        return queued

    def hand_off(self):
        if self.futures is not None:
            return
        from ..protocol.replay_native import CompiledReplay

        self.launch_roots()
        bv = self.verifier
        with bv.timings.stage("decomp_dispatch"):
            self.futures = [
                None if ys is None else self.executor.submit(
                    lambda p=bv._prefetch_d2h(ys), m=m:
                    CompiledReplay.pack_ext_y(bv._fetch(p), m))
                for ys, m in zip(self.ys, self.counts)]
        self.xs = self.ys = None

    def result(self, group):
        self.hand_off()
        return self.futures[group].result()


@dataclass
class BatchResult:
    ok: bool
    num_proofs: int
    failed_indices: list = field(default_factory=list)


class BatchVerifier:
    """Verify many proofs with one deferred pairing and device MSMs.

    device: None (CUDA, raising if absent) or an explicit torch device.
    msm: "forest" (the device forest MSM), "scan" (the device sort-and-scan
    MSM) or "host" (the exact native host MSM, for orchestration tests on
    the CPU; refused on a CUDA device).
    limb_backend: the scan MSM's limb format, "u16" ((16, B) int32 limbs)
    or "f8" ((32, B) float32 limbs); both give the same window totals.
    decomp: run the device sqrt pre-pass in verify_stream; None = on for a
    CUDA device, off otherwise.
    pairing: "host" (the native pairing) or "device" (ops/pairing.py on
    this verifier's device); its stage in `timings` is "<pairing>_pairing".
    strategy: "accumulator" (one pairing per batch) or "single" (one per
    proof).
    mesh: a parallel.mesh.Mesh; the verifier runs on its device, and its
    MSMs are sharded over its ranks (device, if given, must name the same
    device). The sqrt pre-pass stays off with a mesh unless decomp=True.
    mesh_shard: None (windows when the mesh size divides NUM_WINDOWS,
    else the point-sharded forest when it divides the total windows, else
    the presorted scan) or "windows", "forest", "scan" to force a kind
    where it applies (the reference's H2V_MESH_SHARD).
    mesh_upload: "shard" or "replicate", the windows kind's point-table
    upload (the reference's H2V_MESH_UPLOAD).
    The forest MSM on one device is the reference's accelerator dispatch
    (msm_forest.dispatch_planned): plan widths pinned per workload, one
    packed upload per batch, on CUDA the chain recorded once per pinned
    signature and replayed, elsewhere run eagerly."""

    # padded sizes quantize to this granularity
    PAD_GRAN = 256

    def __init__(self, params, vk, multiopen="shplonk", hash_name="blake2b",
                 device=None, rng=None, strategy="accumulator",
                 pairing="host", msm="forest", decomp=None, mesh=None,
                 limb_backend=msm_scan.DEFAULT_BACKEND, mesh_shard=None,
                 mesh_upload="shard"):
        if strategy not in ("accumulator", "single"):
            raise ValueError(f"unknown strategy {strategy!r} "
                             "(expected 'accumulator' or 'single')")
        if mesh is not None and not isinstance(mesh, pmesh.Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh_shard not in (None, "windows", "forest", "scan"):
            raise ValueError(f"unknown mesh_shard {mesh_shard!r} (expected "
                             "None, 'windows', 'forest' or 'scan')")
        if mesh_upload not in pmesh.UPLOADS:
            raise ValueError(f"unknown mesh_upload {mesh_upload!r} "
                             f"(expected one of {pmesh.UPLOADS})")
        if msm not in ("forest", "scan", "host"):
            raise ValueError(f"unknown msm {msm!r} (expected 'forest', "
                             "'scan' or 'host')")
        if limb_backend not in ("u16", "f8"):
            raise ValueError(f"unknown limb_backend {limb_backend!r} "
                             "(expected 'u16' or 'f8')")
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None and not pmesh.same_device(
                    resolve_device(device), mesh.device):
                raise ValueError(f"device {device} conflicts with the "
                                 f"mesh's device {mesh.device}")
            self.device = mesh.device
        if msm == "host" and self.device.type == "cuda":
            raise ValueError("msm='host' runs the MSM on the CPU; it is for "
                             "CPU orchestration tests, not a CUDA device")
        self.pairing = pairing
        self._pairing_fn = pairing_backend(pairing, self.device)
        self.params = params
        self.vk = vk
        self.multiopen = multiopen
        self.hash_name = hash_name
        self.strategy = strategy
        self.msm = msm
        self.limb_backend = limb_backend
        self.mesh = mesh
        self.mesh_shard = mesh_shard
        self.mesh_upload = mesh_upload
        self.mesh_wire_stats = {}
        # per-workload plan-width pins (msm_forest.pin_plan_widths), keyed
        # by repr(tuple(sizes)) as the reference keys them; re-pins counts
        # a pin that grew. The forest's recordings are kept per pin key
        self._plan_pins = {}
        self._pin_lock = threading.Lock()
        self.plan_repins = 0
        self.forest_recordings = msm_forest.ForestRecordings()
        # the mesh path keeps host decompression, as the reference's does
        self.decomp = (self.device.type == "cuda" and mesh is None) \
            if decomp is None else bool(decomp)
        if rng is not None:
            self._rng = rng
        elif mesh is not None and mesh.spans_processes:
            # SPMD ranks must fold IDENTICAL isolation weights, or the
            # sharded MSM mixes two linear combinations and valid batches
            # are rejected: a seed of fresh entropy from rank 0 drives one
            # deterministic generator on every rank
            seed = int(pmesh.broadcast(mesh, torch.tensor(
                [secrets.randbits(63)], dtype=torch.int64))[0])
            prng = random.Random(seed)
            self._rng = lambda: 1 + prng.randrange(R - 1)
        else:
            self._rng = lambda: 1 + secrets.randbelow(R - 1)
        # localization (replay/_bisect share CompiledReplay programs) is
        # serialized across the stream pipeline's finish workers
        self._finish_lock = threading.Lock()
        self._vm_programs = {}
        self.timings = StageTimings()
        # cumulative MSM work counters: entries dispatched to the device
        # (including shape padding), device point adds, decomp lanes
        self.msm_entries_dispatched = 0
        self.point_adds_dispatched = 0
        self.decomp_points_dispatched = 0

    # ------------------------------------------------------------ replay
    def replay(self, proofs_and_instances):
        """Host stage: replay every proof's transcript; returns the list of
        per-proof DualMSMs (unevaluated) or raises on malformed proofs.
        Items are (proof, instances) or (proof, instances, vk)."""
        fast = self._replay_vm_batch(proofs_and_instances)
        if fast is not None:
            return fast
        duals = []
        for item in proofs_and_instances:
            with self.timings.stage("host_replay"):
                duals.append(self._replay_one(*item))
        return duals

    def _replay_vm_batch(self, items):
        """Native-VM replay of the whole batch, grouped by (vk, instance
        shape) programs. Returns None when the VM is unavailable or a
        program fails to trace."""
        from ..protocol.replay_native import (
            CompiledReplay,
            MalformedProof,
            vm_available,
        )

        if not vm_available():
            return None
        groups = {}  # key -> [(orig_idx, proof, instances)]
        with self.timings.stage("host_replay"):
            try:
                for i, item in enumerate(items):
                    proof, instances = item[0], item[1]
                    vk = item[2] if len(item) > 2 else self.vk
                    shape = tuple(len(c) for c in instances)
                    key = (vk.content_digest(), shape)
                    if key not in self._vm_programs:
                        self._vm_programs[key] = CompiledReplay(
                            self.params, vk, shape,
                            multiopen=self.multiopen,
                            hash_name=self.hash_name,
                        )
                    groups.setdefault(key, []).append((i, proof, instances))
                duals = [None] * len(items)
                for key, members in groups.items():
                    out = self._vm_programs[key].replay_batch(
                        [(p, inst) for _, p, inst in members],
                        timings=self.timings,
                    )
                    for (i, _, _), d in zip(members, out):
                        duals[i] = d
                return duals
            except MalformedProof:
                raise
            except Exception:
                # tracing/VM edge: stay correct on the Python path
                return None

    def _replay_one(self, proof, instances, vk=None):
        transcript = TRANSCRIPT_READERS[self.hash_name](proof)
        holder = {}

        class _Capture:
            def process(self, f):
                holder["dual"] = f(DualMSM(self.params_ref))
                return holder["dual"]

        cap = _Capture()
        cap.params_ref = self.params
        # each batch item carries ONE proof's instances ([column][row])
        verify_proof(self.params, vk or self.vk, cap, [instances], transcript,
                     multiopen=self.multiopen)
        return holder["dual"]

    def _eval_combined(self, duals, weights, pad_to=None):
        """Evaluate sum_i w_i * (left_i, right_i) on the device."""
        left = []
        right = []
        for dual, w in zip(duals, weights):
            for s, b in zip(dual.left.scalars, dual.left.bases):
                left.append((s * w % R, b))
            for s, b in zip(dual.right.scalars, dual.right.bases):
                right.append((s * w % R, b))
        handle = self._msm_dispatch_pair(left, right, pads=pad_to)
        points = self._collect_pair(handle)
        return points[0], points[1]

    def _msm_dispatch_pair(self, left, right, pads=None, timings=None):
        """Enqueue BOTH accumulator MSMs as one grouped device dispatch.
        Returns an async handle; no host sync here.

        pads: per-side padded entry counts — None (quantize each side to
        PAD_GRAN), an int (both sides, as the bisection path does), or a
        (pad_left, pad_right) tuple. timings: as _dispatch_limbs'."""
        # vk-shared bases repeat across every proof in the batch: summing
        # their scalars on the host collapses ~1/3 of the entries
        left = _dedup_entries(left)
        right = _dedup_entries(right)
        if pads is None:
            pads = tuple(
                max(-(-len(e) // self.PAD_GRAN) * self.PAD_GRAN,
                    self.PAD_GRAN)
                for e in (left, right)
            )
        elif isinstance(pads, int):
            pads = (pads, pads)
        groups = []
        for entries, pad in zip((left, right), pads):
            if len(entries) > pad:
                raise ValueError("MSM side larger than its pad size")
            groups.append(entries + [(0, None)] * (pad - len(entries)))
        ss, xs, ys = [], [], []
        for entries in groups:
            for s, pt in entries:
                ss.append(s % R)
                if pt is None:
                    xs.append(0)
                    ys.append(0)
                else:
                    xs.append(pt[0])
                    ys.append(pt[1])
        return self._dispatch_limbs(ints_to_limbs(ss), ints_to_limbs(xs),
                                    ints_to_limbs(ys),
                                    [len(g) for g in groups], timings)

    def _dispatch_limbs(self, s_np, x_np, y_np, sizes, timings=None,
                        before_upload=None):
        """Dispatch the grouped MSM from canonical limb arrays (scalars and
        affine coords, concatenated per group). Returns the async handle.

        timings: a StageTimings that gets the single-device forest
        dispatch's parts (dispatch_plan: host_plan, with its plan_native
        and plan_canonicalize, and the pin, plan_pin; the dispatch's own,
        see msm_forest.dispatch_planned; dispatch_prefetch); the stream
        passes its own, the bisection none. before_upload: called by the
        forest dispatch between its pack and its upload (see
        msm_forest.ForestRecordings.dispatch), by no other."""
        self.msm_entries_dispatched += s_np.shape[0]
        if self.msm == "host":
            # exact host MSM (native C++ Pippenger), for orchestration
            # tests on the CPU
            ss = limbs_to_ints(s_np)
            xs = limbs_to_ints(x_np)
            ys = limbs_to_ints(y_np)
            out, off = [], 0
            for size in sizes:
                sl = slice(off, off + size)
                pts = [
                    (x, y) if (x or y) else None
                    for x, y in zip(xs[sl], ys[sl])
                ]
                pairs = [(s, p) for s, p in zip(ss[sl], pts)
                         if p is not None]
                out.append(hc.g1_msm([s for s, _ in pairs],
                                     [p for _, p in pairs])
                           if pairs else None)
                off += size
            return ("host", out)
        if self.mesh is not None:
            return self._dispatch_mesh(s_np, x_np, y_np, sizes)
        if self.msm == "scan":
            idx_sorted, keys_sorted, levels = msm_scan.host_plan(s_np, sizes)
            # device point-add lanes: the segmented scan's levels over all
            # (entry, window) lanes + the two bucket suffix scans
            self.point_adds_dispatched += msm_scan.scan_lanes(
                idx_sorted.shape[0], len(sizes) * NUM_WINDOWS, levels)
            arr = msm_scan.msm_window_totals_grouped(
                x_np, y_np, idx_sorted, keys_sorted, len(sizes), levels,
                self.device, backend=self.limb_backend)
            return ("grouped", self._prefetch_d2h(arr))
        key = repr(tuple(sizes))
        with maybe_stage(timings, "dispatch_plan"):
            plan = msm_forest.host_plan(s_np, sizes, timings=timings)
            # pin the level/part-width signature per workload: random
            # weights drift widths across quantization boundaries batch to
            # batch, and each new signature is a new recording
            with maybe_stage(timings, "plan_pin"), self._pin_lock:
                old_pin = self._plan_pins.get(key)
                plan, pin = msm_forest.pin_plan_widths(plan, old_pin)
                if pin != old_pin:
                    self._plan_pins[key] = pin
                    self.plan_repins += old_pin is not None
        # device point adds: forest levels (plan, with the pin's pad adds)
        # + per-window bit-plane bucket reduction (7-level tree over 128
        # buckets x 8 bit planes + 14-step Horner, see
        # msm_forest.plane_reduce)
        self.point_adds_dispatched += plan["adds"] + (
            len(sizes) * NUM_WINDOWS * (127 * 8 + 14)
        )
        arr = msm_forest.dispatch_planned(
            x_np, y_np, plan, self.device,
            recordings=self.forest_recordings, slot=key, timings=timings,
            before_upload=before_upload)
        with maybe_stage(timings, "dispatch_prefetch"):
            return ("grouped", self._prefetch_d2h(arr))

    def _dispatch_mesh(self, s_np, x_np, y_np, sizes):
        """The sharded kinds, by the reference's fall-through: windows when
        the mesh size D divides NUM_WINDOWS, else the point-sharded forest
        when D divides the total windows, else the presorted scan with
        its entries padded to a multiple of D; mesh_shard forces a kind
        where it applies, msm="scan" goes to the scan. Every rank returns
        the (D, 3, nlimbs, .) totals of all ranks; the counters count this
        rank's work."""
        D = self.mesh.size
        tw = len(sizes) * NUM_WINDOWS
        pref = self.mesh_shard
        forest = self.msm == "forest"
        if forest and pref in (None, "windows") and NUM_WINDOWS % D == 0:
            self.mesh_wire_stats = {}
            arr = pmesh.sharded_forest_by_windows(
                self.mesh, x_np, y_np, s_np, sizes,
                stats=self.mesh_wire_stats, upload=self.mesh_upload)
            self.point_adds_dispatched += self.mesh_wire_stats["point_adds"]
            return ("sharded_windows", self._prefetch_d2h(arr))
        if forest and pref in (None, "forest") and tw % D == 0:
            self.mesh_wire_stats = {}
            arr = pmesh.sharded_forest_window_totals(
                self.mesh, x_np, y_np, s_np, sizes,
                stats=self.mesh_wire_stats)
            self.point_adds_dispatched += self.mesh_wire_stats["point_adds"]
            return ("sharded_forest", self._prefetch_d2h(arr))
        idx_sorted, keys_sorted, levels = msm_scan.host_plan(s_np, sizes)
        rem = (-idx_sorted.shape[0]) % D
        if rem:
            # identity-point entries in the last segment: the complete add
            # absorbs identities, the repeated key keeps the order sorted
            zero = np.zeros((1, x_np.shape[1]), x_np.dtype)
            x_np = np.concatenate([x_np, zero])
            y_np = np.concatenate([y_np, zero])
            idx_sorted = np.concatenate([
                idx_sorted, np.full(rem, x_np.shape[0] - 1, idx_sorted.dtype)])
            keys_sorted = np.concatenate([
                keys_sorted, np.full(rem, keys_sorted[-1], keys_sorted.dtype)])
        self.point_adds_dispatched += msm_scan.scan_lanes(
            idx_sorted.shape[0] // D, tw, levels)
        arr = pmesh.sharded_window_totals_presorted(
            self.mesh, x_np, y_np, idx_sorted, keys_sorted,
            total_windows=tw, levels=levels, backend=self.limb_backend)
        return ("sharded_grouped", self._prefetch_d2h(arr))

    def _prefetch_d2h(self, arr):
        """Enqueue the device->host copy of a result tensor right at
        dispatch time: a non-blocking copy into a fresh pinned buffer plus
        a recorded event. The reader waits on the event, then reads the
        buffer; a buffer is never reused. On the CPU the tensor itself is
        the result."""
        if not arr.is_cuda:
            return arr, None
        buf = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
        buf.copy_(arr, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event

    @staticmethod
    def _fetch(prefetched):
        buf, event = prefetched
        if event is not None:
            event.synchronize()
        return buf.numpy()

    def _stream_groups(self, batch):
        """Group a stream batch's indices by (vk, instance shape) and
        compile/look up the VM program for each. Returns [(program, idxs)]
        in first-appearance order, or None when the fast path doesn't
        apply."""
        from ..protocol.replay_native import CompiledReplay, vm_available

        if not vm_available():
            return None
        groups = {}
        order = []
        for i, item in enumerate(batch):
            vk = item[2] if len(item) > 2 else self.vk
            shape = tuple(len(c) for c in item[1])
            key = (vk.content_digest(), shape)
            if key not in self._vm_programs:
                try:
                    self._vm_programs[key] = CompiledReplay(
                        self.params, vk, shape, multiopen=self.multiopen,
                        hash_name=self.hash_name,
                    )
                except Exception:
                    return None
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(i)
        return [(self._vm_programs[k], groups[k]) for k in order]

    def _prefetch_decomp(self, batch, executor):
        """Gather and stage a batch's compressed x-coordinates for the
        device sqrt pre-pass (one group per vk group). Returns its
        _PendingDecomp, or None where the pre-pass doesn't apply. Called
        one batch AHEAD in verify_stream."""
        if not self.decomp:
            return None
        with self.timings.stage("decomp_dispatch"):
            groups = self._stream_groups(batch)
            if groups is None:
                return None
            xs, counts = [], []
            for program, idxs in groups:
                if not program.n_points:
                    xs.append(None)
                    counts.append(0)
                    continue
                x = program.gather_point_xs([batch[i][0] for i in idxs])
                xs.append(stage_x_batch(x, self.device))
                counts.append(x.shape[0])
        return _PendingDecomp(self, xs, counts, executor)

    def _fast_stream_dispatch(self, batch, pads, decomp=None,
                              decomp_next=None):
        """VM raw fast path for a stream batch: replay with the per-proof
        isolation weights folded in-VM (per vk group), assemble the two
        accumulator MSMs as numpy limb arrays, dispatch. decomp: the
        batch's _PendingDecomp; decomp_next: the next batch's, its roots
        launched between the pack and the upload of a packed forest
        dispatch, handed off after the dispatch.
        Returns (handle, pads) or None when inapplicable. MalformedProof
        propagates."""
        groups = self._stream_groups(batch)
        if groups is None:
            return None
        try:
            weights = [self._rng() for _ in batch]
            sides = {"left": [], "right": []}
            for gi, (program, idxs) in enumerate(groups):
                sub = [(batch[i][0], batch[i][1]) for i in idxs]
                w = [weights[i] for i in idxs]
                ext_y = None
                if decomp is not None and decomp.counts[gi]:
                    with self.timings.stage("decomp_wait"):
                        ext_y = decomp.result(gi)
                with self.timings.stage("host_replay"):
                    sc, pt = program.replay_batch_raw(
                        sub, w, ext_y=ext_y, timings=self.timings)
                with self.timings.stage("host_assemble"):
                    garrs = program.batch_msm_arrays(sc, pt, len(sub))
                for side in sides:
                    sides[side].append(garrs[side])
            arrs = {
                side: tuple(np.concatenate([g[c] for g in parts])
                            for c in range(3))
                for side, parts in sides.items()
            }
        except VerifyFailure:
            raise
        except Exception:
            return None
        if pads is None:
            pads = tuple(
                max(-(-arrs[s][0].shape[0] // self.PAD_GRAN)
                    * self.PAD_GRAN, self.PAD_GRAN)
                for s in ("left", "right")
            )
        parts = {"s": [], "x": [], "y": []}
        sizes = []
        for side, pad in zip(("left", "right"), pads):
            S, X, Y = arrs[side]
            m = S.shape[0]
            if m > pad:
                raise ValueError("stream batch grew past the pinned pad size")
            if m < pad:
                z = np.zeros((pad - m, S.shape[1]), dtype=S.dtype)
                S, X, Y = (np.concatenate([a, z]) for a in (S, X, Y))
            parts["s"].append(S)
            parts["x"].append(X)
            parts["y"].append(Y)
            sizes.append(pad)
        with self.timings.stage("device_msm_dispatch"):
            handle = self._dispatch_limbs(
                np.concatenate(parts["s"]),
                np.concatenate(parts["x"]),
                np.concatenate(parts["y"]),
                sizes, self.timings,
                decomp_next.launch_roots if decomp_next is not None
                else None,
            )
        if decomp_next is not None:
            decomp_next.hand_off()
        return handle, pads

    def _collect_pair(self, handle):
        """Wait for a dispatched MSM pair's window totals (stage
        msm_wait), exact host fold (msm_combine); in a localization both
        fall inside its stage."""
        kind, arr = handle
        if kind == "host":
            return arr
        combine = {
            "grouped": combine_window_totals_grouped,
            "sharded_windows": pmesh.combine_sharded_windows,
            "sharded_forest": pmesh.combine_sharded_forest,
            "sharded_grouped": pmesh.combine_sharded_grouped,
        }[kind]
        with self.timings.stage("msm_wait"):
            totals = self._fetch(arr)
        with self.timings.stage("msm_combine"):
            return combine(totals, 2)

    def _pairing_ok(self, left, right) -> bool:
        with self.timings.stage(f"{self.pairing}_pairing"):
            return self._pairing_fn([
                (left, self.params.s_g2),
                (right, hc.g2_neg(self.params.g2)),
            ])

    # ------------------------------------------------------------- verify
    def verify(self, proofs_and_instances, localize=True) -> BatchResult:
        if self.strategy == "single":
            return self._verify_individually(proofs_and_instances)
        n = len(proofs_and_instances)
        try:
            duals = self.replay(proofs_and_instances)
        except Exception:
            # a malformed proof: fall back to per-proof replay to identify
            return self._verify_individually(proofs_and_instances)
        weights = [self._rng() for _ in duals]
        left, right = self._eval_combined(duals, weights)
        if self._pairing_ok(left, right):
            return BatchResult(True, n)
        if not localize:
            return BatchResult(False, n)
        with self.timings.stage("localize"):
            # one padded size for all bisection subsets
            max_entries = max(
                sum(len(duals[i].left.scalars) for i in range(n)),
                sum(len(duals[i].right.scalars) for i in range(n)),
            )
            pad_to = -(-max_entries // self.PAD_GRAN) * self.PAD_GRAN
            failed = self._bisect(duals, list(range(n)), pad_to)
        return BatchResult(False, n, failed)

    def verify_stream(self, batches, pad_to=None, localize=True):
        """Pipelined verification of a stream of proof batches: while the
        device runs batch k's MSMs, the host replays batch k+1, and the
        sqrt pre-pass runs one batch ahead of replay. Yields a BatchResult
        per input batch, in order.

        pad_to pins the MSM size across batches; defaults to the first
        batch's padded size (keep batch sizes uniform)."""
        if self.strategy == "single":
            for batch in batches:
                yield self._verify_individually(batch)
            return
        # finish (wait + fetch + pairing) runs on worker threads so it
        # overlaps the NEXT batch's replay; two workers keep batch k's
        # pairing from serializing behind batch k+1's device wait. A mesh
        # of several ranks keeps one, as the reference does. With a
        # process group a failing batch is localized here, on the
        # dispatching thread: its bisection issues collectives, which
        # every rank must issue in one order, and never beside another
        # thread's
        spmd = self.mesh is not None and self.mesh.group is not None
        depth = 1 if self.mesh is not None and self.mesh.size > 1 else 2
        executor = ThreadPoolExecutor(max_workers=depth)
        # decomp fetch+pack gets its own worker
        decomp_executor = ThreadPoolExecutor(max_workers=1)
        pending = deque()  # FIFO of (Future[BatchResult], batch, duals)
        stream_pads = (pad_to, pad_to) if pad_to is not None else None

        def submit(batch, duals, handle):
            pending.append((executor.submit(
                self._finish_pipelined, batch, duals, max(stream_pads),
                handle, localize and not spmd), batch, duals))

        def result():
            fut, batch, duals = pending.popleft()
            with self.timings.stage("finish_wait"):
                res = fut.result()
            if spmd and localize and not res.ok:
                res = self._localize(batch, duals, max(stream_pads))
            return res

        def batches_with_decomp():
            """One-batch lookahead for the device sqrt pre-pass: the next
            batch's gather before this one is replayed; its launch in
            this batch's packed dispatch (the roots' kernel between the
            pack and the upload, the hand-off after the dispatch), or at
            the latest here, before the gather after it."""
            it = iter(batches)
            cur = next(it, None)
            if cur is None:
                return
            cur_d = self._prefetch_decomp(cur, decomp_executor)
            while cur is not None:
                if cur_d is not None:
                    cur_d.hand_off()
                nxt = next(it, None)
                nxt_d = (self._prefetch_decomp(nxt, decomp_executor)
                         if nxt is not None else None)
                yield cur, cur_d, nxt_d
                cur, cur_d = nxt, nxt_d

        try:
            for batch, decomp, decomp_next in batches_with_decomp():
                try:
                    fast = self._fast_stream_dispatch(batch, stream_pads,
                                                      decomp, decomp_next)
                except VerifyFailure:
                    while pending:
                        yield result()
                    yield self._verify_individually(batch)
                    continue
                if fast is not None:
                    handle, pads = fast
                    stream_pads = stream_pads or pads
                    submit(batch, None, handle)
                    while len(pending) > depth:
                        yield result()
                    continue
                try:
                    duals = self.replay(batch)
                except Exception:
                    while pending:
                        yield result()
                    yield self._verify_individually(batch)
                    continue
                weights = [self._rng() for _ in duals]
                left = []
                right = []
                for dual, w in zip(duals, weights):
                    for s, b in zip(dual.left.scalars, dual.left.bases):
                        left.append((s * w % R, b))
                    for s, b in zip(dual.right.scalars, dual.right.bases):
                        right.append((s * w % R, b))
                if stream_pads is None:
                    stream_pads = tuple(
                        max(-(-len(e) // self.PAD_GRAN) * self.PAD_GRAN,
                            self.PAD_GRAN)
                        for e in (left, right)
                    )
                with self.timings.stage("device_msm_dispatch"):
                    handle = self._msm_dispatch_pair(left, right,
                                                     stream_pads,
                                                     self.timings)
                submit(batch, duals, handle)
                while len(pending) > depth:
                    yield result()
            while pending:
                yield result()
        finally:
            executor.shutdown(wait=True)
            decomp_executor.shutdown(wait=True)

    def _finish_pipelined(self, batch, duals, pad, handle, localize):
        left, right = self._collect_pair(handle)
        n = len(batch)
        if self._pairing_ok(left, right):
            return BatchResult(True, n)
        if not localize:
            return BatchResult(False, n)
        return self._localize(batch, duals, pad)

    def _localize(self, batch, duals, pad):
        """Bisect a failed stream batch. Serialized: replay/_bisect share
        the per-vk CompiledReplay programs."""
        with self.timings.stage("localize"), self._finish_lock:
            if duals is None:
                duals = self.replay(batch)
            return BatchResult(
                False, len(batch), self._bisect(duals, list(range(len(batch))),
                                                pad))

    def _bisect(self, duals, indices, pad_to):
        """Localize failing proofs by bisection over already-replayed MSMs
        (log(n) pairings instead of n)."""
        weights = [self._rng() for _ in indices]
        left, right = self._eval_combined(
            [duals[i] for i in indices], weights, pad_to
        )
        if self._pairing_ok(left, right):
            return []
        if len(indices) == 1:
            return indices
        mid = len(indices) // 2
        return self._bisect(duals, indices[:mid], pad_to) + self._bisect(
            duals, indices[mid:], pad_to
        )

    def _verify_individually(self, proofs_and_instances) -> BatchResult:
        from ..protocol.verifier import verify_proof_single

        failed = []
        for i, item in enumerate(proofs_and_instances):
            proof, instances = item[0], item[1]
            vk = item[2] if len(item) > 2 else self.vk
            if not verify_proof_single(self.params, vk, proof,
                                       [instances],
                                       multiopen=self.multiopen,
                                       hash_name=self.hash_name,
                                       pairing=self.pairing,
                                       device=self.device):
                failed.append(i)
        return BatchResult(not failed, len(proofs_and_instances), failed)
