"""Host-planned addition-forest Pippenger MSM — the grouped batch MSM of
the main path (port of halo2_verifier_tpu/ops/msm_forest.py).

The host knows every entry's bucket key (the scalars arrive with the proof
bytes), so it plans the whole bucket reduction as an explicit ADDITION
FOREST of per-level gather-index arrays:

  level l: frontier_{l+1}[i] = frontier_l[iL[i]] + frontier_l[iR[i]]

Pairing entries within each equal-key run halves every run per level, so
the device does ~M point adds for M (point, window) entries. Identity-slot
padding (the complete add absorbs identities) keeps widths quantized.

The bucket reduction uses the bit decomposition sum_k k*B_k =
sum_b 2^b S_b: each bit plane S_b is a 7-level pair-add tree over its 128
buckets and the 2^b weights fold in a WINDOW_BITS-step Horner.

Host half (planning): copied from the reference unchanged, so plans equal
the reference's array for array, with its plan-width pins
(pin_plan_widths). Device half: one chain, the reference's accelerator
dispatch. dispatch_planned writes every operand of a plan into one int32
buffer at the reference's offsets, uploads it with one copy and runs the
chain on views of it (packed_chain); on the card the chain is recorded
once per pinned signature as a CUDA graph and then only replayed
(ForestRecordings), the counterpart of the reference's compiled stage
programs. The chain is forest_grid, then plane_reduce: the grid's copy of
a cached identity grid, the level-0 frontier launch (csrc/frontier.cu:
convert the affine points and gather them by point_idx0), one point-add
launch per level that also writes the level's finished part into the
bucket grid (scatter lanes past its add lanes), one launch of the deepest
part's scatter lanes, 7 folds and 14 Horner steps that read their
operands by cached indices; a k=14 batch's recording is 32 kernel nodes
and one copy, no PyTorch kernel. The mesh (parallel/mesh.py) calls
forest_grid and plane_reduce itself, with its own collectives between
them.

Output: one stacked (3, NLIMBS, groups*NUM_WINDOWS) Montgomery projective
window-totals tensor, combined on the host by
ops/msm.combine_window_totals_grouped.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from . import curve
from . import field as fm
from . import kernels
from .field import FQ, I32, I64
from .limbs import LIMB_BITS, NLIMBS
from .msm import NUM_BUCKETS, NUM_WINDOWS, WINDOW_BITS
from ..utils.metrics import maybe_stage


def _quant(n: int, q: int) -> int:
    return -(-n // q) * q


def host_plan(scalars_np, groups, quant: int | None = None,
              window_lo: int = 0, window_count: int | None = None,
              timings=None):
    """Plan the whole forest: native C++ planner when available (counting
    sort + analytic level construction, ~13x the numpy path — it sits on
    the main-thread critical path between VM replay and device dispatch),
    numpy otherwise. Both produce bitwise-identical plans
    (tests/test_msm_forest.py::test_native_plan_parity).

    window_lo/window_count select a window subset per group — the
    window-sharded multi-chip path plans chip d over windows
    [d*W/D, (d+1)*W/D) of every group (keys local to the subset).

    timings: an optional utils.metrics.StageTimings that gets the plan's
    parts: plan_native (the planner, native or numpy) and
    plan_canonicalize (_canonicalize_plan)."""
    with maybe_stage(timings, "plan_native"):
        plan = _host_plan_native(scalars_np, groups, quant, window_lo,
                                 window_count)
        if plan is None:
            plan = host_plan_np(scalars_np, groups, quant, window_lo,
                                window_count)
    with maybe_stage(timings, "plan_canonicalize"):
        return _canonicalize_plan(plan)


def _canonicalize_plan(plan):
    """Pin the plan's SHAPE SIGNATURE across batches of one workload.

    The level count and the set of levels carrying finished parts wobble
    with the batch's random isolation weights (e.g. 8 vs 9 levels, a
    level-0 part present or not) — each flip retraces/recompiles a stage
    program MID-STREAM (~2.8 s stalls observed on the v5e bench runs).
    Canonical form: level count padded to a multiple of 3 with identity
    no-op levels (id-slot gathers — the trailing frontier pad slots are
    identities by induction), and a (dump-keyed, identity-gathering)
    finished part at EVERY level. Device cost of the padding is a few
    thousand absorbed identity adds; the payoff is one compiled program
    per workload instead of one per plan shape."""
    levels = list(plan["levels"])
    widths = [plan["point_idx0"].shape[0]] + [l[0].shape[0] for l in levels]
    target = -(-max(len(levels), 1) // 3) * 3
    pad_adds = 0
    for _ in range(len(levels), target):
        prev_w = widths[-1]
        # dummy width = input width: matches what a REAL extra level would
        # quantize to at these shapes, so 8- and 9-level plans land on the
        # same signature instead of a floor-width odd one out
        iL = np.full(prev_w, prev_w - 1, dtype=np.int32)
        levels.append((iL, iL.copy()))
        widths.append(prev_w)
        pad_adds += prev_w
    fin_quant = min(
        (pos.shape[0] for _lvl, pos, _k in plan["finished"]), default=2048
    )
    dump = plan["tw"] * NUM_BUCKETS
    finished = list(plan["finished"])
    have = {lvl for lvl, _pos, _k in finished}
    for lvl in range(len(levels) + 1):
        if lvl not in have:
            finished.append((
                lvl,
                np.full(fin_quant, widths[lvl] - 1, dtype=np.int32),
                np.full(fin_quant, dump, dtype=np.int32),
            ))
    finished.sort(key=lambda t: t[0])
    plan["levels"] = levels
    plan["finished"] = finished
    plan["adds"] = plan["adds"] + pad_adds
    return plan


def _host_plan_native(scalars_np, groups, quant=None, window_lo=0,
                      window_count=None):
    from .. import native

    lib = native.load()
    if lib is None or not hasattr(lib, "h2v_forest_plan"):
        return None
    import ctypes

    total = scalars_np.shape[0]
    if window_count is None:
        window_count = NUM_WINDOWS
    if quant is None:
        quant = 4096 if total * window_count >= 65536 else 256
    fin_quant = min(quant, 2048)
    floor = min(quant, 2048)
    sizes = ([total // groups] * groups if isinstance(groups, int)
             else list(groups))
    n_groups = len(sizes)
    sc = np.ascontiguousarray(scalars_np, dtype=np.uint32)
    sz = np.asarray(sizes, dtype=np.uint64)
    max_entries = total * window_count
    max_levels = 40
    point_idx0 = np.empty(max_entries + quant + 1, dtype=np.int32)
    levels_cap = 2 * (max_entries + max_levels * (quant + floor) + 2)
    levels_buf = np.empty(levels_cap, dtype=np.int32)
    level_widths = np.empty(max_levels, dtype=np.uint64)
    fin_cap = max_entries + (max_levels + 2) * fin_quant
    fin_pos = np.empty(fin_cap, dtype=np.int32)
    fin_keys = np.empty(fin_cap, dtype=np.int32)
    fin_meta = np.empty(2 * (max_levels + 2), dtype=np.uint64)
    header = np.empty(6, dtype=np.uint64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.h2v_forest_plan(
        p(sc, ctypes.c_uint32), total, p(sz, ctypes.c_uint64), n_groups,
        quant, fin_quant, floor, window_lo, window_count,
        p(point_idx0, ctypes.c_int32), point_idx0.shape[0],
        p(levels_buf, ctypes.c_int32), levels_cap,
        p(level_widths, ctypes.c_uint64), max_levels,
        p(fin_pos, ctypes.c_int32), p(fin_keys, ctypes.c_int32), fin_cap,
        p(fin_meta, ctypes.c_uint64), max_levels + 2,
        p(header, ctypes.c_uint64),
    )
    if rc != 0:
        return None
    w_pad, n_levels, n_parts, entries, adds, n_pad = (int(v)
                                                      for v in header)
    levels = []
    off = 0
    for li in range(n_levels):
        w = int(level_widths[li])
        levels.append((levels_buf[off:off + w],
                       levels_buf[off + w:off + 2 * w]))
        off += 2 * w
    parts = []
    off = 0
    for pi in range(n_parts):
        lvl = int(fin_meta[2 * pi])
        w = int(fin_meta[2 * pi + 1])
        parts.append((lvl, fin_pos[off:off + w], fin_keys[off:off + w]))
        off += w
    return {
        "point_idx0": point_idx0[:w_pad],
        "levels": levels,
        "finished": parts,
        "tw": n_groups * window_count,
        "window_lo": window_lo,
        "n_pad": n_pad,
        "entries": entries,
        "adds": adds,
    }


def host_plan_np(scalars_np, groups, quant: int | None = None,
                 window_lo: int = 0, window_count: int | None = None):
    """Plan the whole forest on host numpy (reference implementation).

    scalars_np: (total, NLIMBS) uint32 canonical scalar limbs, groups
    concatenated; `groups` is an int (equal sizes) or per-group sizes.
    Returns a dict consumed by dispatch_planned. Zero digits are dropped
    here (they contribute nothing), so the device never sees them.
    window_lo/window_count select a per-group window subset (the
    window-sharded multi-chip path); keys are local to the subset.
    """
    total = scalars_np.shape[0]
    if window_count is None:
        window_count = NUM_WINDOWS
    if quant is None:
        # small problems quantize finer so level shapes stay tiny; large
        # ones coarser so shape classes (= compile variants) stay few.
        # 4096 keeps batch-to-batch width jitter (~sqrt(entries) per
        # level) inside one class while wasting <6% at bench shapes
        quant = 4096 if total * window_count >= 65536 else 256
    if isinstance(groups, int):
        assert total % groups == 0
        sizes = [total // groups] * groups
    else:
        sizes = list(groups)
        assert sum(sizes) == total
    per_limb = LIMB_BITS // WINDOW_BITS
    digit_cols = []
    for w in range(window_lo, window_lo + window_count):
        limb = w // per_limb
        shift = WINDOW_BITS * (w % per_limb)
        digit_cols.append(
            (scalars_np[:, limb] >> shift) & np.uint32(NUM_BUCKETS - 1)
        )
    digits = np.stack(digit_cols, axis=1)  # (total, window_count)
    group_id = np.repeat(
        np.arange(len(sizes), dtype=np.uint32), sizes
    )[:, None]
    win = np.arange(window_count, dtype=np.uint32)[None, :]
    keys = (
        group_id * np.uint32(window_count * NUM_BUCKETS)
        + win * np.uint32(NUM_BUCKETS)
        + digits
    ).reshape(-1)
    point_idx = np.broadcast_to(
        np.arange(total, dtype=np.int32)[:, None], digits.shape
    ).reshape(-1)
    nz = (keys & np.uint32(NUM_BUCKETS - 1)) != 0
    keys = keys[nz]
    point_idx = point_idx[nz]
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    idx0 = point_idx[order]

    # identity lane: unique points pad to a 1024 multiple with >= 1 zero
    # lane; canonical (0,0) converts/maps to the projective identity
    n_pad = _quant(total + 1, 1024)
    id_idx = n_pad - 1

    w_real = idx0.shape[0]
    w_pad = _quant(w_real + 1, quant)
    point_idx0 = np.full(w_pad, id_idx, dtype=np.int32)
    point_idx0[:w_real] = idx0

    # Each level: (a) buckets already reduced to ONE entry leave the
    # frontier — they are finalized by a gather from THIS level's frontier
    # at scatter time, so they stop costing pass-through adds (without
    # removal, ~tw*NUM_BUCKETS singletons ride every remaining level:
    # ~45% of all adds at bench shapes); (b) remaining equal-key runs
    # pair up and halve. Total device adds = entries - buckets + padding.
    levels = []      # per level: (iL, iR) gather pairs into next frontier
    finished = []    # per level: (pos_in_frontier, keys) finalized there
    cur_keys = keys
    prev_pad = w_pad
    while cur_keys.shape[0]:
        wl = cur_keys.shape[0]
        starts = np.empty(wl, dtype=bool)
        starts[0] = True
        np.not_equal(cur_keys[1:], cur_keys[:-1], out=starts[1:])
        seg_start_pos = np.flatnonzero(starts)
        seg_len = np.diff(np.append(seg_start_pos, wl))
        seg_id = np.cumsum(starts) - 1
        single = seg_len[seg_id] == 1
        fin_pos = np.flatnonzero(single)
        id_slot = prev_pad - 1  # inductively identity (pads add identities)
        if fin_pos.shape[0]:
            finished.append((len(levels), fin_pos.astype(np.int32),
                             cur_keys[fin_pos].astype(np.int32), id_slot))
        act_pos = np.flatnonzero(~single)
        if not act_pos.shape[0]:
            break
        act_keys = cur_keys[act_pos]
        wa = act_keys.shape[0]
        starts2 = np.empty(wa, dtype=bool)
        starts2[0] = True
        np.not_equal(act_keys[1:], act_keys[:-1], out=starts2[1:])
        seg_start2 = np.flatnonzero(starts2)
        seg_id2 = np.cumsum(starts2) - 1
        rank2 = np.arange(wa) - seg_start2[seg_id2]
        even = (rank2 & 1) == 0
        has_partner = np.zeros(wa, dtype=bool)
        has_partner[:-1] = even[:-1] & (act_keys[1:] == act_keys[:-1])
        out_pos = np.flatnonzero(even)
        # width floor: deep (narrow) levels share one compiled add variant
        # instead of one per shrinking width — identity-pad compute there
        # is cheap, Mosaic kernel compiles are ~20 s each
        floor = min(quant, 2048)
        out_pad = max(_quant(out_pos.shape[0] + 1, quant), floor)
        iL = np.full(out_pad, id_slot, dtype=np.int32)
        iR = np.full(out_pad, id_slot, dtype=np.int32)
        iL[:out_pos.shape[0]] = act_pos[out_pos]
        partner = np.minimum(out_pos + 1, wa - 1)  # clipped; gated below
        iR[:out_pos.shape[0]] = np.where(
            has_partner[out_pos], act_pos[partner], id_slot
        )
        levels.append((iL, iR))
        cur_keys = act_keys[even]
        prev_pad = out_pad

    tw = len(sizes) * window_count
    dump = tw * NUM_BUCKETS
    # pad each level's finished slice (identity-slot positions scatter to
    # the dump bucket) so part widths fall into few compiled shape classes
    fin_quant = min(quant, 2048)
    parts = []
    for lvl, pos, kk, id_slot in finished:
        m = pos.shape[0]
        pad = _quant(max(m, 1), fin_quant)
        pos_p = np.full(pad, id_slot, dtype=np.int32)
        keys_p = np.full(pad, dump, dtype=np.int32)
        pos_p[:m] = pos
        keys_p[:m] = kk
        parts.append((lvl, pos_p, keys_p))
    if not parts:  # all digits zero: scatter only identity padding
        parts.append((0, np.full(fin_quant, w_pad - 1, dtype=np.int32),
                      np.full(fin_quant, dump, dtype=np.int32)))
    return {
        "point_idx0": point_idx0,
        "levels": levels,
        "finished": parts,
        "tw": tw,
        "window_lo": window_lo,
        "n_pad": n_pad,
        "entries": w_real,
        "adds": sum(l[0].shape[0] for l in levels),
    }


def pin_plan_widths(plan, pinned=None):
    """Pad a plan's frontier widths up to a PINNED per-workload signature
    so every batch of one workload shares one recorded chain (the
    reference's pin_plan_widths, unchanged).

    _canonicalize_plan stabilizes the level COUNT and part layout, but
    each level's width still quantizes per batch: random isolation weights
    shift the nonzero-digit counts by ~sqrt(entries), and a width sitting
    near a quantization boundary flips shape class batch to batch.

    Padding semantics: every frontier's trailing slot is an identity by
    induction (host_plan always leaves >= 1 identity pad slot), so extra
    gather rows (id, id) append identity adds that the complete RCB15
    add absorbs. Finished-part positions keep referencing their original
    (real) slots.

    Returns (plan, widths): pass `widths` back in for the next batch; a
    batch that EXCEEDS the pinned signature re-pins (one new recording,
    then stable again)."""
    widths = [plan["point_idx0"].shape[0]] + [
        lvl[0].shape[0] for lvl in plan["levels"]
    ]
    fin_widths = [pos.shape[0] for _lvl, pos, _k in plan["finished"]]
    sig = (tuple(widths), tuple(fin_widths))
    if (pinned is None or len(pinned[0]) != len(widths)
            or len(pinned[1]) != len(fin_widths)
            or any(w > p for w, p in zip(widths, pinned[0]))
            or any(w > p for w, p in zip(fin_widths, pinned[1]))):
        # natural widths grew past the pin (or first batch): re-pin
        if pinned is not None and len(pinned[0]) == len(widths) \
                and len(pinned[1]) == len(fin_widths):
            pinned = (
                tuple(max(w, p) for w, p in zip(widths, pinned[0])),
                tuple(max(w, p) for w, p in zip(fin_widths, pinned[1])),
            )
        else:
            pinned = sig
    pad0 = pinned[0][0] - widths[0]
    if pad0:
        plan["point_idx0"] = np.concatenate([
            plan["point_idx0"],
            np.full(pad0, plan["n_pad"] - 1, dtype=np.int32),
        ])
    levels = []
    pad_adds = 0
    for i, (iL, iR) in enumerate(plan["levels"]):
        pad = pinned[0][i + 1] - iL.shape[0]
        if pad:
            id_slot = pinned[0][i] - 1  # last slot of the padded frontier
            iL = np.concatenate([iL, np.full(pad, id_slot, np.int32)])
            iR = np.concatenate([iR, np.full(pad, id_slot, np.int32)])
            pad_adds += pad
        levels.append((iL, iR))
    plan["levels"] = levels
    dump = plan["tw"] * NUM_BUCKETS
    parts = []
    for pi, (lvl, pos, keys) in enumerate(plan["finished"]):
        pad = pinned[1][pi] - pos.shape[0]
        if pad:
            id_slot = pinned[0][lvl] - 1  # identity slot of frontier lvl
            pos = np.concatenate([pos, np.full(pad, id_slot, np.int32)])
            keys = np.concatenate([keys, np.full(pad, dump, np.int32)])
        parts.append((lvl, pos, keys))
    plan["finished"] = parts
    plan["adds"] = plan["adds"] + pad_adds
    return plan, pinned


_LEAF_IDX_CACHE = {}


def _bucket_leaf_idx(tw: int):
    """Static gather indices for the bit-plane reduction: for each window
    w and digit bit b, the 128 buckets whose digit has bit b set, laid out
    (w, b)-major. Depends only on tw — computed once, reused forever."""
    idx = _LEAF_IDX_CACHE.get(tw)
    if idx is None:
        per_bit = [
            [k for k in range(1, NUM_BUCKETS) if (k >> b) & 1]
            for b in range(WINDOW_BITS)
        ]
        idx = np.asarray(
            [
                w * NUM_BUCKETS + k
                for w in range(tw)
                for b in range(WINDOW_BITS)
                for k in per_bit[b]
            ],
            dtype=np.int32,
        )
        _LEAF_IDX_CACHE[tw] = idx
    return idx


def pad_transpose_points(x_np, y_np, n_pad):
    """(total, NLIMBS) canonical affine limbs -> limbs-major (NLIMBS,
    n_pad) uint32 arrays, identity (0, 0) in the pad lanes: the point
    table of a plan whose n_pad is n_pad."""
    total = x_np.shape[0]
    xs = np.zeros((NLIMBS, n_pad), dtype=np.uint32)
    ys = np.zeros((NLIMBS, n_pad), dtype=np.uint32)
    xs[:, :total] = x_np.T
    ys[:, :total] = y_np.T
    return xs, ys


# ------------------------------------------------------------ device half

def check_plan(plan):
    """Every gather index must lie inside the frontier it reads, and every
    scatter key must name a slot of the (tw * NUM_BUCKETS + 1)-slot grid:
    the point-add kernel reads by index and its scatter lanes write by key
    without a bounds check, so the plan is validated here on the host,
    before any index reaches the card."""
    widths = [plan["n_pad"], plan["point_idx0"].shape[0]]
    widths += [iL.shape[0] for iL, _iR in plan["levels"]]
    arrays = [(plan["point_idx0"], widths[0])]
    for li, (iL, iR) in enumerate(plan["levels"]):
        arrays += [(iL, widths[li + 1]), (iR, widths[li + 1])]
    for lvl, pos, _keys in plan["finished"]:
        arrays.append((pos, widths[lvl + 1]))
    for a, w in arrays:
        if a.size and (int(a.min()) < 0 or int(a.max()) >= w):
            raise ValueError("forest plan index out of range")
    dump = plan["tw"] * NUM_BUCKETS
    for _lvl, _pos, keys in plan["finished"]:
        if keys.size and (int(keys.min()) < 0 or int(keys.max()) > dump):
            raise ValueError("forest plan scatter key out of range")


def upload(a, device, dtype=I32):
    """A numpy array as a `dtype` tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dtype)


def _convert_points(xs, ys):
    """(NLIMBS, n_pad) int32 canonical affine limbs -> projective
    Montgomery points on the plain bodies; (0, 0) lanes, including the
    identity pad, map to the identity."""
    r2 = FQ.col("r2", xs.device).expand_as(xs)
    gx = fm.mont_mul_body(xs.to(I64), r2, FQ).to(I32)
    gy = fm.mont_mul_body(ys.to(I64), r2, FQ).to(I32)
    return curve.from_affine(gx, gy)


def _gather(f, idx):
    return tuple(c.index_select(1, idx) for c in f)


def frontier0_plain(xs, ys, idx0):
    """Plain version of the level-0 frontier kernel: convert every point
    lane (_convert_points), then gather the frontier's lanes by the plan's
    point_idx0 (the reference's _convert_points + _gather0)."""
    return _gather(_convert_points(xs, ys), idx0.to(I64))


def frontier0(xs, ys, idx0):
    """The level-0 frontier (X, Y, Z), (NLIMBS, w0) int32 each, from the
    (NLIMBS, n_pad) int32 canonical affine limbs and the (w0,) int32
    point_idx0: one launch of csrc/frontier.cu for CUDA tensors, the
    plain version for CPU tensors."""
    if xs.is_cuda:
        return kernels.forest_frontier0(xs, ys, idx0)
    return frontier0_plain(xs, ys, idx0)


# ------------------------------------------------ packed, recorded dispatch

class PackedLayout(NamedTuple):
    """Where each operand of a plan lies in the packed int32 buffer, the
    reference's _dispatch_fuse3_packed layout: [xs | ys | idx0 | iL_0 |
    iR_0 | ... | iL_{L-1} | iR_{L-1} | pos_0 | ... | pos_L | scatter keys].
    A pinned plan's layout is the same for every batch of its workload,
    so it is also the signature a recording is kept under."""
    n_pad: int
    w0: int
    levels: tuple   # (oL, oR, w) per level
    parts: tuple    # (oP, wp) per finished part, levels 0..L in order
    scatter: tuple  # (oS, ws)
    tw: int

    @property
    def total(self) -> int:
        return self.scatter[0] + self.scatter[1]


def packed_layout(plan) -> PackedLayout:
    n_pad = int(plan["n_pad"])
    w0 = int(plan["point_idx0"].shape[0])
    off = 2 * NLIMBS * n_pad + w0
    levels = []
    for iL, _iR in plan["levels"]:
        w = int(iL.shape[0])
        levels.append((off, off + w, w))
        off += 2 * w
    parts = []
    for _lvl, pos, _keys in plan["finished"]:
        parts.append((off, int(pos.shape[0])))
        off += int(pos.shape[0])
    ws = sum(int(keys.shape[0]) for _lvl, _pos, keys in plan["finished"])
    return PackedLayout(n_pad, w0, tuple(levels), tuple(parts), (off, ws),
                        int(plan["tw"]))


def pack_operands(x_np, y_np, plan, layout, out):
    """Write one batch's operands into `out`, a (layout.total,) int32
    numpy array (on the card, the view of a pinned staging buffer): the
    points transposed to limbs-major rows with (0, 0) in the pad lanes,
    then the plan's index arrays at the layout's offsets."""
    n_pad, total = layout.n_pad, x_np.shape[0]
    o = NLIMBS * n_pad
    for k, a in enumerate((x_np, y_np)):
        rows = out[k * o:(k + 1) * o].reshape(NLIMBS, n_pad)
        rows[:, :total] = a.T
        rows[:, total:] = 0
    out[2 * o:2 * o + layout.w0] = plan["point_idx0"]
    for (iL, iR), (oL, oR, w) in zip(plan["levels"], layout.levels):
        out[oL:oL + w] = iL
        out[oR:oR + w] = iR
    for (_lvl, pos, _keys), (oP, wp) in zip(plan["finished"], layout.parts):
        out[oP:oP + wp] = pos
    off = layout.scatter[0]
    for _lvl, _pos, keys in plan["finished"]:
        out[off:off + keys.shape[0]] = keys
        off += keys.shape[0]


_STATIC = {}


def _static_on(name: str, n: int, device, make):
    """make(n), a CPU tensor, on `device`, made once per (name, n,
    device): a recorded chain reads it, so it must exist before the
    recording starts (the slot's eager first batch makes it)."""
    key = (name, n, str(device))
    t = _STATIC.get(key)
    if t is None:
        t = _STATIC[key] = make(n).to(device)
    return t


def _identity_grid(tw: int):
    """(3, NLIMBS, tw * NUM_BUCKETS + 1) int32 projective identities
    (0 : R : 0): the bucket grid before any part is written, the dump slot
    last."""
    grid = torch.zeros((3, NLIMBS, tw * NUM_BUCKETS + 1), dtype=I32)
    grid[1] = FQ.col("r", "cpu").to(I32)
    return grid


def _leaf_pairs(tw: int):
    """The first fold's operands, (2, tw * WINDOW_BITS * 64) int32: the
    even and odd entries of _bucket_leaf_idx(tw), so lane i adds the grid's
    leaves 2i and 2i + 1 of the bit-plane layout."""
    leaf = _bucket_leaf_idx(tw)
    return torch.from_numpy(np.stack([leaf[0::2], leaf[1::2]]))


def _pair_idx(width: int):
    """A later fold's operands, (2, width // 2) int32: 2i and 2i + 1."""
    return torch.arange(width, dtype=I32).view(-1, 2).t().contiguous()


def _horner_idx(tw: int):
    """(WINDOW_BITS, tw) int32: row b holds plane b of every window,
    w * WINDOW_BITS + b, in the (w, b)-major plane sums."""
    return (torch.arange(tw, dtype=I32) * WINDOW_BITS
            + torch.arange(WINDOW_BITS, dtype=I32)[:, None]).contiguous()


def scatter_part_plain(f, pos, keys, grid):
    """Plain version of a launch's scatter lanes: grid[:, keys[j]] =
    f[:, pos[j]] with Y := R where Y = Z = 0 (so an entry that reads as
    (0 : 0 : 0) lands as the identity (0 : R : 0)), in place. Duplicate
    keys occur only at the dump slot, which no reduction reads."""
    part = _gather(f, pos.to(I64))
    empty = fm.is_zero(part[1]) & fm.is_zero(part[2])
    one = FQ.col("r", part[1].device).to(part[1].dtype)
    part = (part[0], torch.where(empty.unsqueeze(0), one, part[1]), part[2])
    k = keys.to(I64)
    for g, c in zip(grid, part):
        g[:, k] = c


def level_scatter(f, iL, iR, pos, keys, grid):
    """One forest level and the finished part read from its input
    frontier f, in one launch for CUDA tensors (kernels.point_add_scatter:
    add lanes, then scatter lanes into `grid`, in place), the plain
    versions for CPU tensors. iL, iR None: the part alone (the deepest).
    Returns the next frontier, or None without add lanes."""
    if f[0].is_cuda:
        out = kernels.point_add_scatter(f, iL, iR, pos, keys, grid)
        return None if iL is None else out
    scatter_part_plain(f, pos, keys, grid)
    return None if iL is None else curve.masked_add_plain(f, f, iL=iL,
                                                          iR=iR)


def _stacked(t):
    """(X, Y, Z) -> (3, NLIMBS, w). A kernel's output is three rows of one
    such tensor (kernels.point_add), which is returned as it is; plain
    outputs are stacked."""
    base = t[0]._base
    if (base is not None and base.shape == (3,) + tuple(t[0].shape)
            and all(c._base is base and c.data_ptr() == base[k].data_ptr()
                    for k, c in enumerate(t))):
        return base
    return torch.stack(t)


def _horner(planes, tw):
    """(X, Y, Z) plane sums, (NLIMBS, tw * WINDOW_BITS) each, (w, b)-major
    -> the window totals sum_b 2^b S_b, (3, NLIMBS, tw), by Horner with a
    complete self-add as the doubling: the first step doubles each
    window's top plane, read by index, and every step adds plane b by
    index; 2 x (WINDOW_BITS - 1) point-add launches."""
    idx = _static_on("horner", tw, planes[0].device, _horner_idx)
    top = idx[WINDOW_BITS - 1]
    t = curve.masked_add(planes, planes, iL=top, iR=top)
    for b in range(WINDOW_BITS - 2, -1, -1):
        if b < WINDOW_BITS - 2:
            t = curve.add(t, t)
        t = curve.masked_add(t, planes, iR=idx[b])
    return _stacked(t)


def plane_reduce(grid, tw):
    """The bucket grid -> the window totals sum_k k*B_k, (3, NLIMBS, tw),
    by the bit decomposition: for each window and digit bit b, a balanced
    tree over the 128 buckets whose digit has bit b set, then the Horner
    fold over the bits. grid: (X, Y, Z) rows or a (3, NLIMBS, n) tensor;
    only its first tw * NUM_BUCKETS slots are read, so a grid with or
    without the dump slot will do. Every index is static and cached on
    the device: the first fold adds the grid's leaf pairs (the leaf
    gather and the fold in one launch), the 6 later folds lanes 2i and
    2i + 1, then _horner; 7 + 14 point-add launches."""
    grid = tuple(grid)
    dev = grid[0].device
    iL, iR = _static_on("leaf_pairs", tw, dev, _leaf_pairs)
    t = curve.masked_add(grid, grid, iL=iL, iR=iR)
    while t[0].shape[1] > tw * WINDOW_BITS:
        iL, iR = _static_on("pairs", t[0].shape[1], dev, _pair_idx)
        t = curve.masked_add(t, t, iL=iL, iR=iR)
    return _horner(t, tw)


def forest_grid(xs, ys, idx0, levels, parts, tw):
    """The forest of a plan, on any device: returns its (3, NLIMBS,
    tw * NUM_BUCKETS + 1) int32 bucket grid, every bucket's sum in
    Montgomery projective form, empty buckets the identity, the dump slot
    last. xs, ys: the (NLIMBS, n_pad) canonical affine limbs; idx0: the
    (w0,) point_idx0; levels: (iL, iR) per level; parts: (pos, keys) per
    finished part, one for each level 0..L in order; all int32 tensors on
    the device.

    The grid is a copy of a cached identity grid; then the level-0
    frontier (frontier0), one launch per level that adds the level and
    writes the finished part read from its input frontier into the grid
    (level_scatter), and one launch for the deepest part: L + 2 launches
    and one copy on the card."""
    grid = _static_on("identity_grid", tw, xs.device, _identity_grid).clone()
    rows = tuple(grid)
    f = frontier0(xs, ys, idx0)
    for (iL, iR), (pos, keys) in zip(tuple(levels) + ((None, None),), parts):
        f = level_scatter(f, iL, iR, pos, keys, rows)
    return grid


def packed_chain(buf, layout):
    """The forest and its bucket reduction on views of the packed (total,)
    int32 buffer, on any device: forest_grid, then plane_reduce. Returns
    the (3, NLIMBS, tw) window totals.

    On the card that is L + 23 kernel launches for L levels (32 on the
    k=14 main path) and one copy, with no PyTorch kernel between them
    (ForestRecordings counts a recording's nodes): every index is a slice
    of the buffer or cached on the device, so the point-add kernel reads
    its operands by index and no gathered copy is made (the reference's
    choice between one and two XLA gathers per level, concat_gather or
    H2V_LEVEL_GATHER, has nothing to decide here); the scatter keys stay
    int32."""
    o, n_pad = NLIMBS * layout.n_pad, layout.n_pad
    levels = [(buf[oL:oL + w], buf[oR:oR + w]) for oL, oR, w in layout.levels]
    parts, oS = [], layout.scatter[0]
    for oP, wp in layout.parts:
        parts.append((buf[oP:oP + wp], buf[oS:oS + wp]))
        oS += wp
    grid = forest_grid(buf[:o].view(NLIMBS, n_pad),
                       buf[o:2 * o].view(NLIMBS, n_pad),
                       buf[2 * o:2 * o + layout.w0], levels, parts,
                       layout.tw)
    return plane_reduce(grid, layout.tw)


def _pool_bytes(graph) -> int:
    """Bytes of the segments of a recording's private memory pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class _Recording:
    """One recorded chain: its layout, the static packed input on the
    card, two pinned staging buffers (the stream keeps two batches in
    flight) with the event after each one's copy, the event after the
    last chain that read the static input, and once recorded the CUDA
    graph, its static output, the launches one replay makes and the
    graph's nodes by type."""

    def __init__(self, layout, device):
        self.layout = layout
        self.device = device
        self.buf = torch.empty(layout.total, dtype=I32, device=device)
        self.staging = [torch.empty(layout.total, dtype=I32,
                                    pin_memory=True) for _ in range(2)]
        # recorded once here, so that each has its CUDA handle for a copy
        # queued from native code (kernels.HostCopy)
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.replayed = torch.cuda.Event()
        for e in (*self.copied, self.replayed):
            e.record()
        self.turn = 0
        self.graph = None
        self.out = None
        self.launches = None
        self.nodes = None
        self.pool_bytes = 0


class ForestRecordings:
    """The packed chain on the card, recorded once per pinned signature
    and then replayed: the counterpart of the reference's stage programs,
    each compiled once per static shape and then only launched.

    One slot per workload (the orchestrator keys them by its pin key): a
    slot holds one recording. A batch whose layout is its slot's is one
    pack into pinned memory, one H2D copy into the recording's static
    input on a copy stream of the device's own (it waits only for the
    last chain that read that input, and the chain waits for it; the
    caller may queue it beside a kernel of its own, before_upload), one
    replay and one copy of the recording's static output,
    which is what the dispatch returns: the copy is queued before the
    lock is released, so no later replay, from this thread or another,
    can overwrite the totals a caller has not read yet. A slot's first
    batch runs the chain eagerly on the static input, then records it; a
    new layout in a slot (a re-pin) frees the slot's recording and
    records anew, the reference's recompile on a re-pin. At most
    `max_slots` recordings live at once: a new slot beyond that frees the
    least recently dispatched one. A capture that fails raises: there is
    no fallback. Dispatches are serialized (the stream's finish workers
    dispatch bisection batches beside the main thread).

    Counters: recorded (recordings made), replaced (recordings a new
    layout freed), evicted (recordings freed for a new slot), replays;
    pool_bytes() sums the live recordings' private memory pools;
    counts(slot) gives a recording's graph nodes by type, read from the
    captured graph, beside the package launches one replay makes: kernel
    nodes beyond those launches are PyTorch kernels left in the chain."""

    def __init__(self, max_slots: int = 4):
        if max_slots < 1:
            raise ValueError(f"max_slots must be at least 1, not {max_slots}")
        self.max_slots = max_slots
        self._slots = OrderedDict()  # least recently dispatched first
        self._lock = threading.Lock()
        self._copy_streams = {}
        self.recorded = 0
        self.replaced = 0
        self.evicted = 0
        self.replays = 0

    def pool_bytes(self) -> int:
        with self._lock:
            return sum(r.pool_bytes for r in self._slots.values())

    def counts(self, slot):
        """(nodes, launches) of the slot's recording: its graph's nodes by
        type (kernels.capture_nodes) and {kernel: (launches, lanes)} of one
        replay."""
        with self._lock:
            rec = self._slots[slot]
            return dict(rec.nodes), dict(rec.launches)

    def _free(self, slot):
        """Drop a slot's recording once its replays and copies are done."""
        torch.cuda.synchronize(self._slots.pop(slot).device)

    def dispatch(self, x_np, y_np, plan, layout, device, slot=None,
                 timings=None, before_upload=None):
        """before_upload: called once the operands are packed with their
        upload, a kernels.HostCopy; it returns True where it queued the
        copy itself (beside a kernel of its own), else the copy is queued
        here."""
        slot = layout if slot is None else slot
        with self._lock, torch.cuda.device(device):
            rec = self._slots.get(slot)
            if rec is not None and (rec.layout != layout
                                    or rec.device != device):
                self._free(slot)
                rec = None
                self.replaced += 1
            if rec is None:
                while len(self._slots) >= self.max_slots:
                    self._free(next(iter(self._slots)))
                    self.evicted += 1
                rec = self._slots[slot] = _Recording(layout, device)
            else:
                self._slots.move_to_end(slot)
            with maybe_stage(timings, "dispatch_pack"):
                s = rec.turn
                rec.turn ^= 1
                rec.copied[s].synchronize()
                pack_operands(x_np, y_np, plan, layout,
                              rec.staging[s].numpy())
            copy = self._copy_streams.get(device)
            if copy is None:
                copy = self._copy_streams[device] = torch.cuda.Stream(device)
            copy.wait_event(rec.replayed)
            h2d = kernels.HostCopy(rec.buf, rec.staging[s], copy,
                                   rec.copied[s])
            queued = before_upload is not None and before_upload(h2d)
            with maybe_stage(timings, "dispatch_h2d"):
                if not queued:
                    kernels.host_copy(h2d)
                torch.cuda.current_stream(device).wait_event(rec.copied[s])
            if rec.graph is None:
                with maybe_stage(timings, "dispatch_record"):
                    try:
                        out = packed_chain(rec.buf, layout)
                        self._record(rec)
                    except BaseException:
                        del self._slots[slot]
                        raise
                rec.replayed.record()
                return out
            with maybe_stage(timings, "dispatch_launch"):
                rec.graph.replay()
                rec.replayed.record()
                kernels.count_replay(rec.launches)
                self.replays += 1
                return rec.out.clone()

    def _record(self, rec):
        """Capture the chain on the recording's static input, on a side
        stream that waits for the work queued before it; the wrappers'
        launches are tallied for count_replay, not counted, and the
        graph's nodes are read before the capture ends."""
        dev = rec.device
        stream = torch.cuda.Stream(dev)
        # as torch.cuda.graph does: nothing queued before the capture is
        # still running when it begins
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with kernels.recorded_launches() as tally, torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = packed_chain(rec.buf, rec.layout)
                nodes = kernels.capture_nodes(dev)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was already invalid; raise the cause
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        rec.graph, rec.out, rec.launches = graph, out, dict(tally)
        rec.nodes = nodes
        rec.pool_bytes = _pool_bytes(graph)
        self.recorded += 1


def _is_canonical(plan) -> bool:
    """The shape the chain reads, which host_plan always gives
    (_canonicalize_plan): one finished part per level 0..L, in order."""
    levels, parts = plan["levels"], plan["finished"]
    return (len(parts) == len(levels) + 1
            and all(parts[i][0] == i for i in range(len(parts))))


def dispatch_planned(x_np, y_np, plan, device, recordings=None, slot=None,
                     timings=None, before_upload=None):
    """Device stage (the reference's accelerator dispatch with its packed
    upload, _dispatch_fuse3_packed): every operand of the plan in one
    int32 buffer, one upload, packed_chain on views of it.
    Returns the (3, NLIMBS, tw) int32 window totals without
    synchronizing.

    x_np/y_np: (total, NLIMBS) uint32 CANONICAL affine limbs ((0,0) =
    identity), as the orchestrator assembles them. A plan without a
    finished part at every level (only a hand-built one) is canonicalized
    on a copy first. On the card the chain runs through `recordings`, the
    caller's ForestRecordings, under `slot` (default the layout): recorded
    once per signature, then replayed; the result is a copy of the
    recording's static output, the caller's to keep. On any other device
    the same chain runs eagerly on the plain versions. timings: an
    optional utils.metrics.StageTimings that gets the dispatch's parts
    (dispatch_check, dispatch_pack, dispatch_h2d: the upload on the card,
    dispatch_launch: the chain, on the card the replay and its output's
    copy, dispatch_record: a slot's first batch and its recording).
    before_upload: called once the operands are packed, before their
    upload: ForestRecordings.dispatch's, elsewhere with None."""
    if not _is_canonical(plan):
        plan = _canonicalize_plan(dict(plan))
    with maybe_stage(timings, "dispatch_check"):
        check_plan(plan)
    layout = packed_layout(plan)
    device = torch.device(device)
    if device.type != "cuda":
        with maybe_stage(timings, "dispatch_pack"):
            buf = np.empty(layout.total, dtype=np.int32)
            pack_operands(x_np, y_np, plan, layout, buf)
        if before_upload is not None:
            before_upload(None)
        with maybe_stage(timings, "dispatch_launch"):
            return packed_chain(torch.from_numpy(buf).to(device), layout)
    if recordings is None:
        raise ValueError("dispatch_planned on CUDA records into the "
                         "caller's ForestRecordings: pass recordings=")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return recordings.dispatch(x_np, y_np, plan, layout, device, slot,
                               timings, before_upload)


def msm_grouped(scalars_np, x_np, y_np, sizes, device):
    """Convenience wrapper: full grouped MSM via the forest; returns a list
    of per-group affine points ((x, y) ints or None). Synchronizes."""
    from .msm import combine_window_totals_grouped

    plan = host_plan(scalars_np, sizes)
    recordings = (ForestRecordings(max_slots=1)
                  if torch.device(device).type == "cuda" else None)
    arr = dispatch_planned(x_np, y_np, plan, device, recordings)
    return combine_window_totals_grouped(arr.cpu().numpy(), len(sizes))
