"""Sort-and-scan Pippenger MSM, the second single-device MSM path (port of
halo2_verifier_tpu/ops/msm_jax.py; the exact host combine lives in
ops/msm.py).

1. All windows at once: every (point, window) pair becomes an entry keyed
   by window*2^c + digit; one sort and one log-depth segmented scan (the
   complete point add as the combine) yield every bucket sum of every
   window.
2. Bucket reduction (summation by parts) is two suffix scans over the
   bucket axis, all windows in one launch per level.
3. The window totals are fetched and combined on the host (ops/msm.py).

Each scan level is ONE launch of the point-add kernel. The reference
rolls the three coordinate arrays by the level's offset and adds; here the
kernel reads its partner lane by index (iR = i -/+ offset, clamped into
range) under the level's mask, so the shifted copy is never made, and it
writes a new tensor, since a level reads lanes that it also writes. The
bucket sums are gathered from the segment ends (the reference scatters
every lane, the non-ends into a dump slot): the host, or a device
searchsorted, knows where each bucket's segment ends, so nothing depends
on which duplicate a scatter keeps and nothing synchronizes.

Both limb formats run the same code through ops/curve.PointOps: "u16"
((16, B) int32) and "f8" ((32, B) float32). Montgomery R is 2^256 in both,
so their window totals are the same residues, re-limbed. The format is an
argument (default "u16"); no environment variable is read. The
reference's high-water marks for the scan depth spare XLA a recompile;
eager PyTorch compiles nothing, so the depth is used as planned.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve
from . import field8 as f8
from .field import FQ, I32, I64
from .limbs import LIMB_BITS, NLIMBS
from .msm import (NUM_BUCKETS, NUM_WINDOWS, WINDOW_BITS,
                  combine_window_totals)

DEFAULT_BACKEND = "u16"


def _ops(backend: str):
    if backend not in ("u16", "f8"):
        raise ValueError(f"unknown limb backend {backend!r} "
                         "(expected 'u16' or 'f8')")
    return curve.OPS8 if backend == "f8" else curve.OPS16


def _to_device(a, device, dtype=I32):
    """numpy (any 32-bit integer type) or torch -> `dtype` tensor on
    `device`."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        a = torch.from_numpy(a)
    return a.to(device).to(dtype)


def _digits(scalars):
    """(n, NLIMBS) canonical scalar limbs -> (n, NUM_WINDOWS) digits;
    window w covers bits [w*c, (w+1)*c)."""
    per_limb = LIMB_BITS // WINDOW_BITS
    parts = []
    for w in range(NUM_WINDOWS):
        limb = w // per_limb
        shift = WINDOW_BITS * (w % per_limb)
        parts.append((scalars[:, limb] >> shift) & (NUM_BUCKETS - 1))
    return torch.stack(parts, dim=1)


def _segmented_inclusive_scan(pts, keys, levels, ops=curve.OPS16):
    """Hillis-Steele inclusive segmented scan (point add as combine) along
    the lane axis of limbs-major coords; keys: (m,) sorted integer tensor
    on the points' device. One point-add launch per level.

    `levels` only needs to cover the longest segment whose sum is USED
    (non-zero-digit buckets); zero-digit segments (discarded later) may be
    left partially summed."""
    m = keys.shape[0]
    idx = torch.arange(m, dtype=I32, device=keys.device)
    for k in range(levels):
        offset = 1 << k
        if offset >= m:
            break  # no lane has a partner: the level changes nothing
        same = torch.zeros(m, dtype=torch.bool, device=keys.device)
        same[offset:] = keys[offset:] == keys[:-offset]
        partner = (idx - offset).clamp_(min=0)  # masked lanes never read it
        pts = ops.masked_add(pts, pts, same, iR=partner)
    return pts


def _suffix_scan_buckets(pts, ops=curve.OPS16):
    """Inclusive suffix sums along the bucket axis (axis 2) of
    (nlimbs, W, B) coords. Flattened to (nlimbs, W*B) lanes the partner of
    lane i is i + offset, under the mask (i mod B) + offset < B, so a
    window never reads its neighbour."""
    nl, w, nb = pts[0].shape
    flat = tuple(c.reshape(nl, w * nb) for c in pts)
    dev = flat[0].device
    idx = torch.arange(w * nb, dtype=I32, device=dev)
    pos = idx % nb
    levels = max((nb - 1).bit_length(), 1)
    for k in range(levels):
        offset = 1 << k
        valid = pos + offset < nb
        partner = torch.where(valid, idx + offset, idx)
        flat = ops.masked_add(flat, flat, valid, iR=partner)
    return tuple(c.reshape(nl, w, nb) for c in flat)


def _bucket_totals(summed, bucket_pos, tw, ops):
    """Scanned entries -> window totals sum_k k*B_k, stacked
    (3, nlimbs, tw). bucket_pos: (tw * NUM_BUCKETS,) lane of each bucket's
    segment end, -1 for an empty bucket."""
    has = (bucket_pos >= 0).unsqueeze(0)
    lane = bucket_pos.clamp(min=0).to(I64)
    nl = ops.nlimbs
    buckets = [
        torch.where(has, c.index_select(1, lane), torch.zeros_like(c[:, :1]))
        .reshape(nl, tw, NUM_BUCKETS)
        for c in summed
    ]
    # empty buckets are all-zero, which is not the (0:1:0) identity
    # encoding; patch Y to Montgomery one
    empty = ops.lfm.is_zero(buckets[1]) & ops.lfm.is_zero(buckets[2])
    one = ops.mont_one(1, buckets[1].device).unsqueeze(2)
    buckets[1] = torch.where(empty.unsqueeze(0), one, buckets[1])
    # summation by parts: suffix-scan buckets 1..B-1 gives running sums;
    # their total (window value sum_k k*B_k) is element 0 of a second scan
    tail = tuple(c[:, :, 1:] for c in buckets)
    suffix = _suffix_scan_buckets(tail, ops)
    totals = _suffix_scan_buckets(suffix, ops)
    return torch.stack([c[:, :, 0] for c in totals])  # (3, nl, tw)


def _segment_ends_device(keys_sorted, total_windows: int):
    """segment_ends on the device, for keys sorted there: a bucket's
    segment ends just before the first larger key."""
    slots = torch.arange(total_windows * NUM_BUCKETS, dtype=keys_sorted.dtype,
                         device=keys_sorted.device)
    end = torch.searchsorted(keys_sorted, slots, right=True) - 1
    found = (end >= 0) & (keys_sorted[end.clamp(min=0)] == slots)
    return torch.where(found, end, torch.full_like(end, -1)).to(I32)


def _neutralize_zero_digits(pts, keys, ops):
    """Zero digits contribute nothing: replace their points by the
    identity."""
    zero_digit = (keys & (NUM_BUCKETS - 1)) == 0
    return ops.select_point(zero_digit,
                            ops.identity(keys.shape[0], keys.device), pts)


def window_totals_impl(scalars, points_x, points_y, device, levels=None):
    """Pippenger bucket accumulation + reduction with the sort on the
    device; returns projective window totals as 3 limbs-major
    (NLIMBS, NUM_WINDOWS) int32 tensors.

    scalars: (n, NLIMBS) canonical (NOT Montgomery) limbs.
    points_x/points_y: (n, NLIMBS) affine Montgomery coords, (0,0) =
    identity. levels: scan depth (see _segmented_inclusive_scan); defaults
    to the worst case log2(n * NUM_WINDOWS).
    """
    ops = curve.OPS16
    scalars = _to_device(scalars, device)
    points_x = _to_device(points_x, device)
    points_y = _to_device(points_y, device)
    n = scalars.shape[0]
    if levels is None:
        levels = max((n * NUM_WINDOWS - 1).bit_length(), 1)
    digits = _digits(scalars)  # (n, W)
    keys = (
        digits
        + (torch.arange(NUM_WINDOWS, dtype=I32, device=device)
           * NUM_BUCKETS)[None, :]
    ).reshape(-1)
    point_idx = torch.arange(n, dtype=I64, device=device)[:, None].expand(
        n, NUM_WINDOWS).reshape(-1)

    # stable, as the reference's sort is: equal keys in another order give
    # the same bucket sums but other projective limbs
    order = torch.argsort(keys, stable=True)
    keys_sorted = keys[order]
    idx_sorted = point_idx[order]
    pts = ops.from_affine(points_x[idx_sorted].T.contiguous(),
                          points_y[idx_sorted].T.contiguous())
    pts = _neutralize_zero_digits(pts, keys_sorted, ops)
    summed = _segmented_inclusive_scan(pts, keys_sorted, levels, ops)

    totals = _bucket_totals(
        summed, _segment_ends_device(keys_sorted, NUM_WINDOWS), NUM_WINDOWS,
        ops)
    return tuple(totals[c] for c in range(3))


# ------------------------------------------------- grouped presorted MSM
#
# The batch orchestrator's scan path. Everything cheap and sequential
# (digit extraction, entry sort, scan-depth choice, segment ends) happens
# on the HOST in numpy; the device does only the wide vector work (gather,
# conversion, segmented scan, bucket reduction). Several independent MSMs
# ("groups", e.g. a DualMSM's left and right) share one dispatch and one
# stacked output tensor.

def host_plan(scalars_np, groups):
    """Host Pippenger plan over concatenated group entries.

    scalars_np: (sum(sizes), NLIMBS) uint32 canonical scalar limbs, the
    groups' entries concatenated. `groups` is an int (equal-sized groups)
    or a list of per-group entry counts. Returns (idx_sorted int32,
    keys_sorted uint32, levels int): entry order sorted by global bucket
    key group*W*B + window*B + digit, and the scan depth covering the
    longest non-zero-digit bucket run (rounded up to even, as the
    reference plans it).
    """
    total = scalars_np.shape[0]
    if isinstance(groups, int):
        sizes = [total // groups] * groups
    else:
        sizes = list(groups)
    if sum(sizes) != total:
        raise ValueError(f"group sizes {sizes} do not cover {total} entries")
    per_limb = LIMB_BITS // WINDOW_BITS
    digit_cols = []
    for w in range(NUM_WINDOWS):
        limb = w // per_limb
        shift = WINDOW_BITS * (w % per_limb)
        digit_cols.append(
            (scalars_np[:, limb] >> shift) & np.uint32(NUM_BUCKETS - 1)
        )
    digits = np.stack(digit_cols, axis=1)  # (total, W)
    group_id = np.repeat(
        np.arange(len(sizes), dtype=np.uint32), sizes
    )[:, None]
    win = np.arange(NUM_WINDOWS, dtype=np.uint32)[None, :]
    keys = (
        group_id * np.uint32(NUM_WINDOWS * NUM_BUCKETS)
        + win * np.uint32(NUM_BUCKETS)
        + digits
    ).reshape(-1)
    point_idx = np.broadcast_to(
        np.arange(total, dtype=np.int32)[:, None], digits.shape
    ).reshape(-1)
    # a stable sort of 16-bit keys is numpy's radix sort, several times
    # faster than its merge sort of 32-bit keys; the order is the same
    narrow = len(sizes) * NUM_WINDOWS * NUM_BUCKETS <= 1 << 16
    order = np.argsort(keys.astype(np.uint16) if narrow else keys,
                       kind="stable")
    keys_sorted = keys[order]
    idx_sorted = point_idx[order]

    nz = keys_sorted[(keys_sorted & (NUM_BUCKETS - 1)) != 0]
    if nz.size:
        counts = np.bincount(nz)
        longest = max(int(counts.max()), 1)
    else:
        longest = 1
    levels = max(longest.bit_length() - (longest & (longest - 1) == 0), 1)
    levels = min(levels + (levels & 1), 32)  # round up to even
    return idx_sorted, keys_sorted, levels


def segment_ends(keys_sorted, total_windows: int):
    """Host: (total_windows * NUM_BUCKETS,) int32 lane of each bucket's
    last entry in the sorted order, -1 for a bucket with no entry."""
    pos = np.full(total_windows * NUM_BUCKETS, -1, dtype=np.int32)
    if keys_sorted.shape[0]:
        ends = np.flatnonzero(
            np.append(keys_sorted[1:] != keys_sorted[:-1], True))
        pos[keys_sorted[ends]] = ends
    return pos


def window_totals_presorted_impl(points_x, points_y, idx_sorted,
                                 keys_sorted, total_windows, levels,
                                 bucket_pos, backend=DEFAULT_BACKEND):
    """Device stage of the grouped MSM: gather points in host-sorted bucket
    order, segmented-scan bucket sums, reduce. Returns ONE stacked
    (3, nlimbs, total_windows) tensor (X, Y, Z window totals) so the caller
    fetches a single buffer; nothing here synchronizes.

    points_x/points_y: (n, NLIMBS) int32 tensors of CANONICAL affine
    16-bit limbs ((0,0) = identity); the Montgomery conversion happens
    here, after the gather, as two wide Montgomery-multiply launches.
    idx_sorted (int64), keys_sorted (int32) and bucket_pos (int32, from
    segment_ends) are tensors on the same device.

    backend: "u16" or "f8"; both compute identical window totals.
    total_windows = groups * NUM_WINDOWS; group g's windows occupy columns
    [g*NUM_WINDOWS, (g+1)*NUM_WINDOWS).
    """
    ops = _ops(backend)
    lfm = ops.lfm
    m = idx_sorted.shape[0]
    dev = points_x.device
    gx_u = points_x.index_select(0, idx_sorted).T.contiguous()
    gy_u = points_y.index_select(0, idx_sorted).T.contiguous()
    if backend == "f8":
        gx_u = f8.expand16_to8(gx_u)
        gy_u = f8.expand16_to8(gy_u)
        r2 = f8.col(FQ, "r2", dev).expand(f8.NLIMBS8, m).contiguous()
    else:
        r2 = FQ.col("r2", dev).to(I32).expand(NLIMBS, m).contiguous()
    gx = lfm.mont_mul(gx_u, r2, FQ)
    gy = lfm.mont_mul(gy_u, r2, FQ)
    pts = ops.from_affine(gx, gy)
    pts = _neutralize_zero_digits(pts, keys_sorted, ops)
    summed = _segmented_inclusive_scan(pts, keys_sorted, levels, ops)
    return _bucket_totals(summed, bucket_pos, total_windows, ops)


def check_plan(n_points: int, idx_sorted, keys_sorted, total_windows: int):
    """Every sorted entry must name a point and a bucket of the grid: the
    device gathers by these indices without a bounds check."""
    if idx_sorted.size and (
            int(idx_sorted.min()) < 0 or int(idx_sorted.max()) >= n_points
            or int(keys_sorted.max()) >= total_windows * NUM_BUCKETS):
        raise ValueError("scan plan index out of range")


def msm_window_totals_grouped(points_x_np, points_y_np, idx_sorted,
                              keys_sorted, groups: int, levels: int,
                              device, backend: str = DEFAULT_BACKEND):
    """Dispatch the grouped MSM (groups = group COUNT); returns the
    (3, nlimbs, g*W) tensor on `device` WITHOUT synchronizing. Inputs are
    host numpy (uploaded here, once), as host_plan returns them."""
    tw = groups * NUM_WINDOWS
    check_plan(points_x_np.shape[0], idx_sorted, keys_sorted, tw)
    return window_totals_presorted_impl(
        _to_device(points_x_np, device), _to_device(points_y_np, device),
        _to_device(idx_sorted, device, I64), _to_device(keys_sorted, device),
        total_windows=tw, levels=levels,
        bucket_pos=_to_device(segment_ends(keys_sorted, tw), device),
        backend=backend,
    )


def scan_lanes(m: int, total_windows: int, levels: int) -> int:
    """Point-add lanes one grouped dispatch launches (masked lanes
    included): the segmented scan's levels over m entries and the two
    suffix scans over the bucket grid."""
    suffix_levels = max((NUM_BUCKETS - 2).bit_length(), 1)
    return (min(levels, max((m - 1).bit_length(), 0)) * m
            + 2 * suffix_levels * total_windows * (NUM_BUCKETS - 1))


def _scan_levels(scalars_np) -> int:
    """Data-driven scan depth: ceil(log2(longest non-zero-digit bucket
    run)), rounded up to even. Exact for ANY input: adversarial digit
    distributions simply get a deeper (up to worst-case) scan."""
    per_limb = LIMB_BITS // WINDOW_BITS
    counts = np.zeros(NUM_WINDOWS * NUM_BUCKETS, dtype=np.int64)
    for w in range(NUM_WINDOWS):
        limb = w // per_limb
        shift = WINDOW_BITS * (w % per_limb)
        d = ((scalars_np[:, limb] >> shift) & (NUM_BUCKETS - 1)).astype(
            np.int64
        )
        counts[w * NUM_BUCKETS:(w + 1) * NUM_BUCKETS] = np.bincount(
            d, minlength=NUM_BUCKETS
        )
        counts[w * NUM_BUCKETS] = 0  # zero-digit buckets are discarded
    longest = max(int(counts.max()), 1)
    levels = max(longest.bit_length() - (longest & (longest - 1) == 0), 1)
    return min(levels + (levels & 1), 32)  # round up to even


def msm_window_totals(scalars, points_x, points_y, device):
    """Window-totals MSM of (n, NLIMBS) numpy limb arrays (canonical
    scalars, Montgomery affine points). Entry counts pad to the next power
    of two with zero scalars (which contribute nothing), as the reference
    pads them, so the totals equal the reference's bit for bit. Returns
    device tensors WITHOUT synchronizing."""
    scalars = np.asarray(scalars)
    levels = _scan_levels(scalars)
    n = scalars.shape[0]
    target = 1 << max((n - 1).bit_length(), 0)
    if target != n:
        padz = np.zeros((target - n, scalars.shape[1]), dtype=scalars.dtype)
        scalars = np.concatenate([scalars, padz])
        points_x = np.concatenate([np.asarray(points_x), padz])
        points_y = np.concatenate([np.asarray(points_y), padz])
    return window_totals_impl(scalars, points_x, points_y, device,
                              levels=levels)


def msm(scalars, points_x, points_y, device):
    """Full MSM: device bucket pipeline + host window combine;
    synchronizes and returns a host affine point (x, y) or None for
    identity."""
    wts = msm_window_totals(scalars, points_x, points_y, device)
    return combine_window_totals(tuple(c.cpu().numpy() for c in wts))


def msm_host(scalars_int, points_affine, device):
    """Convenience wrapper: python ints / host affine points in, host
    affine point out. The exactness oracle is ops.hostcurve.g1_msm."""
    from .constants import P, R
    from .limbs import ints_to_limbs

    n = len(scalars_int)
    if n != len(points_affine):
        raise ValueError("msm_host: scalars and points differ in number")
    if n == 0:
        return None
    xs, ys = [], []
    for pt in points_affine:
        if pt is None:
            xs.append(0)
            ys.append(0)
        else:
            xs.append(pt[0] * FQ.mont_r % P)
            ys.append(pt[1] * FQ.mont_r % P)
    return msm(ints_to_limbs([s % R for s in scalars_int]),
               ints_to_limbs(xs), ints_to_limbs(ys), device)
