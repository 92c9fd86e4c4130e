#!/usr/bin/env python3
"""Sweep a kernel's launch shape and body on one card.

Two kernels, each built from scratch copies of the sources, one copy per
variant, through ops/kernels.build_report (every variant's nvcc started
together), which reports ptxas' registers and spill bytes and the SASS
counts of `cuobjdump -sass`; a build that spills is reported and not
timed. Every other build is checked bit for bit against the plain version
and timed with CUDA events, all variants of one launch in turns (forward,
then backward), with seeded canonical operands of the main path's shapes,
and with the profiler, which gives the device time of a call's kernels
(CUDA events around a few lanes' launches time the host's dispatch).

point_add: the masked point adds, K2 (csrc/point_add.cu, 16-bit limbs)
and K5 (csrc/point_add8.cu, 8-bit limbs in float32), per body and launch
shape (point.cuh AddShape): the unrolled or the rolled body, and block
size x minimum blocks per SM, the `__launch_bounds__` pair that caps
registers at 65,536 / (block x blocks), each with no launch narrow; and
K2's narrow shape (point.cuh NarrowShape) per threads per output lane x
block size, every launch narrow. Launches:
- scan: 532,480 lanes reading one frontier at i and i - 1, 97 % of the
  lanes adding (the scan's level 0, one k=14 batch);
- forest: 266,240 lanes gathering pairs from a 524,288-lane frontier, no
  mask (the forest's first level);
- pairs_<n>: n lanes adding lanes 2i and 2i + 1 of a 2n-lane frontier
  (the chain's narrow levels, folds and Horner steps), at the chain's
  widths; pairs_64_scatter: the same at 64 lanes through
  h2v_point_add_scatter with no scatter lanes (the forest levels'
  entry).

sqrt: the decomp pre-pass's square root (csrc/mont_mul.cu
h2v_sqrt_principal), per block size, exponent window and lanes per thread
(mont_mul.cu SqrtShape), at the main path's 15,360 lanes (15 points x
1,024 proofs) and at 32 lanes (one warp: one chain's latency).

fq12_mul: the device pairing's fused Fq12 multiply (csrc/tower.cu
h2v_fq12_mul) per lanes per block and threads per output of its
recombination map (tower.cu Fq12Shape), at the pairing's 1 and 2 lanes
and at 16,384.

fq_inv: the Fermat inversion T3 (tower.cu h2v_fq_inv) per block size and
exponent window (tower.cu InvShape), at the pairing's 2 lanes and at
16,384, for Fq (and Fr at 16,384).

miller_step: the device pairing's affine Miller step (tower.cu
h2v_miller_step) per block size and mode instantiation (tower.cu
MillerShape: the mode a template parameter, or read at run time), in
each mode at the pairing's 2 lanes and at 16,384. A version without
h2v_miller_step (a --parent from before it) runs the step as the
composition it replaced: one _line_double or _line_add on the tower's
dispatching helpers, whose T1, K1 and T3 launches go to that version's
kernels; `device_ms_package` sums those launches' device time alone
(`device_ms` adds the composition's torch ops).

point_double: the complete doubling K3 (csrc/point_double.cu
h2v_point_double) per block size and minimum blocks per SM
(point_double.cu DoubleShape), at the doubling path's 524,288 lanes and
at 32 (one warp).

--parent NAME=DIR (repeatable) adds another version's csrc/ directory as
a variant, built and timed as it stands, to compare versions on one card
in one call (unpack one with `git archive <commit>
halo2_verifier_tpu_torch/csrc` into a gitignored directory such as
`_t_parent/`).

Prints one JSON line per variant and launch, then the table and the
card's name and power limit. Needs a CUDA card.

Usage: python3 sweep_kernels.py {point_add,sqrt,fq12_mul,fq_inv,
                                 miller_step,point_double}
                                [--reps N] [--parent NAME=DIR ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SCAN_LANES = 532480
FOREST_LANES = 266240
FOREST_FRONTIER = 524288
ACTIVE_SHARE = 0.97
SQRT_LANES = (15360, 32)
TOWER_LANES = (1, 2, 16384)
DOUBLE_LANES = (524288, 32)
# the packed chain's point-add widths below the wide shape's full card: the
# Horner steps, the folds, the deep forest levels (k=14 and k=9 batches)
NARROW_LANES = (64, 512, 1024, 2048, 4096, 8192, 12288, 16384, 20480,
                28672, 32768, 36864)


class PointAdd:
    """K2 and K5 per body x (block size, minimum blocks per SM): no cap,
    then caps of 168 and 128 registers, no launch narrow; then K2's
    narrow shape per (threads per lane, block size), every launch narrow
    (the wide shape as shipped)."""

    header = "point.cuh"
    build_sources = ("point_add.cu", "point_add8.cu")
    sources = {"point_add": "point_add.cu",
               "point_add_scatter": "point_add.cu",
               "point_add8": "point_add8.cu"}
    labels = dict.fromkeys(sources, "point_add_kernel")
    variants = ([(body, shape) for body in ("unrolled", "rolled")
                 for shape in ((64, 1), (64, 6), (64, 8), (128, 1), (128, 3),
                               (128, 4), (256, 1), (256, 2), (512, 1))]
                + [("narrow", (group, block)) for group in (4, 8)
                   for block in (32, 64, 128)])
    # AddShape's fields, set alike for both limb formats in a variant, and
    # NarrowShape's
    fields = {"kThreads": r"static constexpr int kThreads = \d+;",
              "kMinBlocks": r"static constexpr int kMinBlocks = \d+;",
              "kRolled": r"static constexpr bool kRolled = (?:true|false);",
              "kGroup": r"static constexpr int kGroup = \d+;",
              "kBlock": r"static constexpr int kBlock = \d+;",
              "kBelow": r"static constexpr int kBelow = \d+;"}
    matches = {"kThreads": 2, "kMinBlocks": 2, "kRolled": 2, "kGroup": 1,
               "kBlock": 1, "kBelow": 1}

    @staticmethod
    def name(v):
        body, (a, b) = v
        return f"narrow_g{a}_{b}" if body == "narrow" else f"{body}_{a}x{b}"

    @staticmethod
    def values(v):
        """The fields a variant sets (a narrow one leaves AddShape as it
        is)."""
        body, (a, b) = v
        if body == "narrow":
            return {"kGroup": f"int kGroup = {a};",
                    "kBlock": f"int kBlock = {b};",
                    "kBelow": f"int kBelow = {1 << 30};"}
        return {"kThreads": f"int kThreads = {a};",
                "kMinBlocks": f"int kMinBlocks = {b};",
                "kRolled": f"bool kRolled = "
                           f"{'true' if body == 'rolled' else 'false'};",
                "kBelow": "int kBelow = 0;"}

    @staticmethod
    def cases(torch, np, dev):
        """{(kernel, launch): (args, plain version)} with seeded canonical
        operands: the u16 frontier and its 8-bit-limb copy."""
        from halo2_verifier_tpu_torch.ops import curve, field8 as f8

        rng = np.random.default_rng(5)
        scan16 = frontier(torch, np, rng, SCAN_LANES, dev)
        scan8 = tuple(f8.expand16_to8(c) for c in scan16)
        i = torch.arange(SCAN_LANES, dtype=torch.int32, device=dev)
        partner = (i - 1).clamp_(min=0)
        mask = torch.from_numpy(rng.random(SCAN_LANES) < ACTIVE_SHARE)
        mask = mask.to(dev)
        mask[0] = False
        forest = frontier(torch, np, rng, FOREST_FRONTIER, dev)
        j = torch.arange(FOREST_LANES, dtype=torch.int32, device=dev)
        iL = (2 * j) % FOREST_FRONTIER
        iR = (2 * j + 1) % FOREST_FRONTIER
        work = {("point_add", "scan"): (scan16, scan16, mask, None, partner),
                ("point_add8", "scan"): (scan8, scan8, mask, None, partner),
                ("point_add", "forest"): (forest, forest, None, iL, iR)}
        for n in NARROW_LANES:
            f = frontier(torch, np, rng, 2 * n, dev)
            j = torch.arange(n, dtype=torch.int32, device=dev)
            work[("point_add", f"pairs_{n}")] = (f, f, None, 2 * j, 2 * j + 1)
            if n == NARROW_LANES[0]:
                work[("point_add_scatter", f"pairs_{n}_scatter")] = (
                    f, f, None, 2 * j, 2 * j + 1)
        for (kname, _launch), args in work.items():
            ops = curve.OPS8 if kname == "point_add8" else curve.OPS16
            yield (kname, _launch), args, (
                lambda ops=ops, args=args: ops.masked_add_plain(*args))

    @staticmethod
    def launch(torch, entries, kname, args):
        """(run, outputs), or (None, None) for a version without the
        entry (a --parent from before h2v_point_add_scatter)."""
        fn = entries.get(f"h2v_{kname}")
        if fn is None:
            return None, None
        p, q, mask, iL, iR = args
        rows = 32 if kname == "point_add8" else 16
        dtype = torch.float32 if kname == "point_add8" else torch.int32
        b = iL.shape[0] if iL is not None else iR.shape[0]
        out = torch.empty((3, rows, b), dtype=dtype, device=p[0].device)

        def ptr(t):
            return None if t is None else t.data_ptr()

        def run():
            stream = torch.cuda.current_stream().cuda_stream
            outs = (out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
            if kname == "point_add_scatter":  # p is q; no scatter lanes
                return fn(*(c.data_ptr() for c in p), p[0].shape[1],
                          ptr(iL), ptr(iR), *outs, b, None, None, 0,
                          None, None, None, 0, stream)
            return fn(*(c.data_ptr() for c in p), p[0].shape[1],
                      *(c.data_ptr() for c in q), q[0].shape[1], ptr(iL),
                      ptr(iR),
                      None if mask is None
                      else mask.view(torch.uint8).data_ptr(),
                      *outs, b, stream)
        return run, tuple(out)


class Sqrt:
    """The square root per (block size, exponent window, lanes per
    thread): the block size at a 4-bit window, the window at 64-thread
    blocks, then two and four lanes per thread (their chains interleaved
    in one thread)."""

    header = "mont_mul.cu"
    build_sources = ("mont_mul.cu",)
    sources = {"sqrt_principal": "mont_mul.cu"}
    labels = {"sqrt_principal": "sqrt_principal_kernel"}
    variants = ([(t, 4, 1) for t in (32, 64, 128, 256)]
                + [(64, w, 1) for w in (1, 3, 5)]
                + [(32, 4, 2), (64, 4, 2), (32, 4, 4)])
    fields = {"kThreads": r"static constexpr int kThreads = \d+;",
              "kWindow": r"static constexpr int kWindow = \d+;",
              "kLanes": r"static constexpr int kLanes = \d+;"}
    matches = 1

    @staticmethod
    def name(v):
        return f"t{v[0]}_w{v[1]}_l{v[2]}"

    @staticmethod
    def values(v):
        return {"kThreads": f"int kThreads = {v[0]};",
                "kWindow": f"int kWindow = {v[1]};",
                "kLanes": f"int kLanes = {v[2]};"}

    @staticmethod
    def cases(torch, np, dev):
        from halo2_verifier_tpu_torch.ops import decomp
        from halo2_verifier_tpu_torch.ops.constants import P
        from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs

        rng = np.random.default_rng(7)
        width = SQRT_LANES[0]
        limbs = rng.integers(0, 1 << 16, size=(16, width), dtype=np.int64)
        limbs[15] = rng.integers(0, P >> 240, size=width)
        edge = [0, 1, 2, P - 1, P - 2, (1 << 253) - 1, P - (1 << 32)]
        limbs[:, :len(edge)] = ints_to_limbs(edge).T
        xs = torch.from_numpy(limbs.astype(np.int32)).to(dev)
        for lanes in SQRT_LANES:
            x = xs[:, :lanes].contiguous()
            yield ("sqrt_principal", str(lanes)), (x,), (
                lambda x=x: decomp.y_principal_plain(x))

    @staticmethod
    def launch(torch, entries, _kname, args):
        fn = entries["h2v_sqrt_principal"]
        (xs,) = args
        out = torch.empty_like(xs)

        def run():
            return fn(xs.data_ptr(), out.data_ptr(), xs.shape[1],
                      torch.cuda.current_stream().cuda_stream)
        return run, out


def canonical(torch, np, rng, shape, dev):
    """Seeded canonical Fq elements as int32 limbs of `shape` (16, ...)."""
    from halo2_verifier_tpu_torch.ops.constants import P

    limbs = rng.integers(0, 1 << 16, size=shape, dtype=np.int64)
    limbs[15] = rng.integers(0, P >> 240, size=shape[1:])
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


class Fq12Mul:
    """The fused Fq12 multiply per (lanes per block, threads per MC
    output), the shipped shape first."""

    header = "tower.cu"
    build_sources = ("tower.cu",)
    sources = {"fq12_mul": "tower.cu"}
    labels = {"fq12_mul": "fq12_mul_kernel"}
    variants = [(2, 4), (1, 1), (1, 4), (4, 4), (8, 2), (8, 4)]
    fields = {"kLanes": r"static constexpr int kLanes = \d+;",
              "kSplit": r"static constexpr int kSplit = \d+;"}
    matches = 1

    @staticmethod
    def name(v):
        return f"l{v[0]}_s{v[1]}"

    @staticmethod
    def values(v):
        return {"kLanes": f"int kLanes = {v[0]};",
                "kSplit": f"int kSplit = {v[1]};"}

    @staticmethod
    def cases(torch, np, dev):
        from halo2_verifier_tpu_torch.ops import pairing as tp

        rng = np.random.default_rng(8)
        width = max(TOWER_LANES)
        a = canonical(torch, np, rng, (16, 12, width), dev)
        b = canonical(torch, np, rng, (16, 12, width), dev)
        for lanes in TOWER_LANES:
            x, y = (t[:, :, :lanes].contiguous() for t in (a, b))
            yield ("fq12_mul", str(lanes)), (x, y), (
                lambda x=x, y=y: tp.fq12_mul_plain(x, y))

    @staticmethod
    def launch(torch, entries, kname, args):
        a, b = args
        out = torch.empty_like(a)
        fused = entries["h2v_fq12_mul"]
        stream = torch.cuda.current_stream().cuda_stream
        return (lambda: fused(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              a.shape[2], stream)), out


class FqInv:
    """T3 per (block size, exponent window): the window at 64-thread
    blocks, then the block size at a 3-bit window."""

    header = "tower.cu"
    build_sources = ("tower.cu",)
    sources = {"fq_inv": "tower.cu"}
    labels = {"fq_inv": "fq_inv_kernel"}
    variants = [(64, 3), (64, 2), (64, 4), (32, 3), (128, 3)]
    fields = {"kInvThreads": r"static constexpr int kInvThreads = \d+;",
              "kWindow": r"static constexpr int kWindow = \d+;"}
    matches = 1

    @staticmethod
    def name(v):
        return f"t{v[0]}_w{v[1]}"

    @staticmethod
    def values(v):
        return {"kInvThreads": f"int kInvThreads = {v[0]};",
                "kWindow": f"int kWindow = {v[1]};"}

    @staticmethod
    def cases(torch, np, dev):
        from halo2_verifier_tpu_torch.ops import field as fm

        rng = np.random.default_rng(9)
        x = canonical(torch, np, rng, (16, max(TOWER_LANES)), dev)
        x[:, 0] = 0  # inv(0) = 0
        for spec, lanes in ((fm.FQ, 2), (fm.FQ, 16384), (fm.FR, 16384)):
            a = x[:, :lanes].contiguous()
            tag = f"{lanes}" + ("_fr" if spec is fm.FR else "")
            yield ("fq_inv", tag), (a, spec.kernel_id), (
                lambda a=a, spec=spec: fm.inv_mont_body(a.long(),
                                                        spec).int())

    @staticmethod
    def launch(torch, entries, _kname, args):
        fn = entries["h2v_fq_inv"]
        a, field_id = args
        out = torch.empty_like(a)
        return (lambda: fn(a.data_ptr(), out.data_ptr(), a.shape[1],
                           field_id,
                           torch.cuda.current_stream().cuda_stream)), out


def compose_step(tp, mode, t, q, px, py):
    """The Miller step as the composition ran it before the step kernel
    (ops/pairing.py _line_double and _line_add): the reference's formulas
    on the tower's dispatching helpers (T1 adds, K1 products, a T3
    inversion), (16, 4, B) stacks in and out, the line stacked from its
    sparse tuple tree."""
    xt, yt = tp._g2_from_stack(t)
    if mode == 0:
        xt2 = tp.fq2_mul(xt, xt)
        lam = tp.fq2_mul((tp._x3(xt2[0]), tp._x3(xt2[1])),
                         tp.fq2_inv((tp._x2(yt[0]), tp._x2(yt[1]))))
        xr, yr = xt, yt
    else:
        xr, yr = tp._g2_from_stack(q)
        lam = tp.fq2_mul(tp.fq2_sub(yt, yr),
                         tp.fq2_inv(tp.fq2_sub(xt, xr)))
    prods = tp.fq2_mul_many([(lam, lam), (lam, xr)])
    if mode == 0:
        x3 = tp.fq2_sub(prods[0], (tp._x2(xt[0]), tp._x2(xt[1])))
    else:
        x3 = tp.fq2_sub(tp.fq2_sub(prods[0], xt), xr)
    c4 = tp.fq2_sub(prods[1], yr)
    b, dev = px.shape[1], px.device
    prods2 = tp.fq2_mul_many([(lam, tp.fq2_sub(xt, x3)),
                              (lam, (px, tp._zero(b, dev)))])
    y3 = tp.fq2_sub(prods2[0], yt)
    line = (((py, tp._zero(b, dev)), tp.fq2_zero(b, dev),
             tp.fq2_zero(b, dev)),
            (tp.fq2_neg(prods2[1]), c4, tp.fq2_zero(b, dev)))
    return tp._g2_stack((x3, y3)), tp._fq12_coeff_stack(line)


class MillerStep:
    """The Miller step per (block size, mode instantiation): the shipped
    shape first, then the block size, then the mode read at run time; a
    parent without the step kernel runs compose_step."""

    header = "tower.cu"
    build_sources = ("tower.cu", "mont_mul.cu")
    sources = {"miller_step": "tower.cu"}
    labels = {"miller_step": "miller_step_kernel"}
    variants = [(64, True), (32, True), (128, True), (64, False)]
    fields = {"kStepThreads": r"static constexpr int kStepThreads = \d+;",
              "kModeTemplate":
                  r"static constexpr bool kModeTemplate = (?:true|false);"}
    matches = 1
    composed = ("fq_addsub_kernel + mont_mul_kernel<0> + fq_inv_kernel "
                "(one _line_double or _line_add)")
    package_kernels = ("miller_step_kernel", "fq_addsub_kernel",
                       "mont_mul_kernel", "fq_inv_kernel")

    @staticmethod
    def name(v):
        return f"t{v[0]}_{'template' if v[1] else 'runtime'}"

    @staticmethod
    def values(v):
        return {"kStepThreads": f"int kStepThreads = {v[0]};",
                "kModeTemplate":
                    f"bool kModeTemplate = {'true' if v[1] else 'false'};"}

    @staticmethod
    def cases(torch, np, dev):
        from halo2_verifier_tpu_torch.ops import pairing as tp

        rng = np.random.default_rng(10)
        width = max(TOWER_LANES)
        T = canonical(torch, np, rng, (16, 4, width), dev)
        Q = canonical(torch, np, rng, (16, 4, width), dev)
        P2 = canonical(torch, np, rng, (16, 2, width), dev)
        for lanes in TOWER_LANES[1:]:
            t, q = (x[:, :, :lanes].contiguous() for x in (T, Q))
            p = (P2[:, 0, :lanes], P2[:, 1, :lanes])  # rows at a stride
            for mode, tag in ((0, "dbl"), (1, "add")):
                qm = q if mode else None
                yield ("miller_step", f"{tag}_{lanes}"), (mode, t, qm, p), (
                    lambda m=mode, t=t, q=qm, p=p:
                        tp.miller_step_plain(m, t, q, p))

    @staticmethod
    def launch(torch, entries, _kname, args):
        from halo2_verifier_tpu_torch.ops import kernels
        from halo2_verifier_tpu_torch.ops import pairing as tp

        mode, t, q, (px, py) = args
        t_out = torch.empty_like(t)
        line = torch.empty((16, 12, t.shape[2]), dtype=torch.int32,
                           device=t.device)
        fused = entries.get("h2v_miller_step")
        if fused is not None:
            return (lambda: fused(
                t.data_ptr(), None if q is None else q.data_ptr(),
                px.data_ptr(), px.stride(0), py.data_ptr(), py.stride(0),
                t_out.data_ptr(), line.data_ptr(), t.shape[2], mode,
                torch.cuda.current_stream().cuda_stream)), (t_out, line)
        # the wrappers launch this version's kernels while it runs
        shim = types.SimpleNamespace(**entries)

        def composed():
            saved = dict(kernels._libs)
            kernels._libs.update({"tower.cu": shim, "mont_mul.cu": shim})
            try:
                got_t, got_line = compose_step(tp, mode, t, q, px, py)
            finally:
                kernels._libs.clear()
                kernels._libs.update(saved)
            t_out.copy_(got_t)
            line.copy_(got_line)
            return 0
        return composed, (t_out, line)


class PointDouble:
    """K3 per (block size, minimum blocks per SM) (point_double.cu
    DoubleShape): the shipped shape first, then caps of 128 to 113
    registers and none."""

    header = "point_double.cu"
    build_sources = ("point_double.cu",)
    sources = {"point_double": "point_double.cu"}
    labels = {"point_double": "point_double_kernel"}
    variants = [(128, 4), (64, 8), (256, 2), (192, 3), (96, 6), (128, 1)]
    fields = {"kThreads": r"static constexpr int kThreads = \d+;",
              "kMinBlocks": r"static constexpr int kMinBlocks = \d+;"}
    matches = 1

    @staticmethod
    def name(v):
        block, blocks = v
        return f"{block}x{blocks}"

    @staticmethod
    def values(v):
        block, blocks = v
        return {"kThreads": f"int kThreads = {block};",
                "kMinBlocks": f"int kMinBlocks = {blocks};"}

    @staticmethod
    def cases(torch, np, dev):
        """Seeded canonical triples (the doubling is field arithmetic on
        any triple) at the doubling path's 524,288 lanes and one warp."""
        from halo2_verifier_tpu_torch.ops import curve

        rng = np.random.default_rng(12)
        p = frontier(torch, np, rng, DOUBLE_LANES[0], dev)
        for lanes in DOUBLE_LANES:
            q = tuple(c[:, :lanes].contiguous() for c in p)
            yield ("point_double", str(lanes)), (q,), (
                lambda q=q: curve.double_plain(q))

    @staticmethod
    def launch(torch, entries, _kname, args):
        fn = entries["h2v_point_double"]
        (p,) = args
        b = p[0].shape[1]
        out = torch.empty((3, 16, b), dtype=torch.int32, device=p[0].device)
        return (lambda: fn(*(c.data_ptr() for c in p),
                           *(o.data_ptr() for o in out), b,
                           torch.cuda.current_stream().cuda_stream)), tuple(
                               out)


KINDS = {"point_add": PointAdd, "sqrt": Sqrt, "fq12_mul": Fq12Mul,
         "fq_inv": FqInv, "miller_step": MillerStep,
         "point_double": PointDouble}


def frontier(torch, np, rng, width, dev):
    from halo2_verifier_tpu_torch.ops.constants import P

    coords = []
    for _ in range(3):
        limbs = rng.integers(0, 1 << 16, size=(16, width), dtype=np.int64)
        limbs[15] = rng.integers(0, P >> 240, size=width)
        coords.append(torch.from_numpy(limbs.astype(np.int32)).to(dev))
    return tuple(coords)


def make_variant(kind, csrc, root, name, v=None):
    """Copy csrc into root/name/csrc; with a variant v, set the shape
    fields it names in the kind's header (which must hold them as in this
    checkout; `matches` times each, one count for every field or a count
    per field)."""
    dst = os.path.join(root, name, "csrc")
    shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
    shutil.copytree(csrc, dst)
    if v is not None:
        path = os.path.join(dst, kind.header)
        with open(path) as f:
            text = f.read()
        for field, value in kind.values(v).items():
            text, n = re.subn(kind.fields[field], "static constexpr "
                              + value, text)
            want = (kind.matches[field] if isinstance(kind.matches, dict)
                    else kind.matches)
            if n != want:
                raise RuntimeError(f"{kind.header} no longer holds its "
                                   f"shape field {field}")
        with open(path, "w") as f:
            f.write(text)
    return dst


def build_all(kernels, kind, variants):
    """kernels.build_report of the kind's sources for every variant, the
    variants' builds all started together; returns {(variant, kernel):
    (the variant's C entries by name, report)}. A version that lacks a
    kernel (a --parent from before it) reports the kind's `composed`
    stand-in."""
    sources = kind.build_sources

    def one(src_dir):
        out_dir = os.path.join(os.path.dirname(src_dir), "build")
        report = kernels.build_report(src_dir, out_dir, sources)
        return report, kernels.build(src_dir, out_dir, sources)

    with ThreadPoolExecutor(len(variants)) as ex:
        done = dict(zip(variants, ex.map(one, variants.values())))
    built = {}
    for name, (report, libs) in done.items():
        entries = {}
        for src in sources:
            lib = ctypes.CDLL(libs[src][0])
            for entry, argtypes in kernels.SIGNATURES[src].items():
                fn = getattr(lib, entry, None)
                if fn is not None:
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    entries[entry] = fn
        for kname, src in kind.sources.items():
            found = [(k, r) for k, r in report[src].items()
                     if kind.labels[kname] in k]
            if not found and not hasattr(kind, "composed"):
                raise RuntimeError(f"{name}: no {kind.labels[kname]} in "
                                   f"{src}'s build, only {list(report[src])}")
            rep = ({"kernel": found[0][0], **found[0][1]} if found
                   else {"kernel": kind.composed})
            if len(found) > 1:  # the largest of every instantiation's
                rep = {"kernel": kind.labels[kname] + "<*>",
                       **{f: max(r.get(f) or 0 for _, r in found)
                          for f in ("registers", "spill_bytes", "sass")},
                       "instantiations": {
                           k: {f: r.get(f) for f in
                               ("registers", "spill_bytes", "sass")}
                           for k, r in found}}
            built[(name, kname)] = (entries, rep)
    return built


def device_ms(torch, run, reps, names=None):
    """Device milliseconds per call of run(): the profiler's kernel
    events over `reps` calls, summed (a composition's launches
    together); with `names`, only the kernels whose name holds one of
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))
             and (names is None or any(n in e.name for n in names)))
    return us / reps / 1e3 if us else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=tuple(KINDS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another version's csrc/ directory (repeatable)")
    args = ap.parse_args(argv)
    parents = dict(p.split("=", 1) for p in args.parent)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sweep_kernels: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from halo2_verifier_tpu_torch.ops import kernels

    kind = KINDS[args.kernel]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    root = os.path.join(kernels.BUILD_DIR, "sweep", args.kernel)
    variants = {name: make_variant(kind, d, root, name)
                for name, d in parents.items()}
    for v in kind.variants:
        variants[kind.name(v)] = make_variant(kind, kernels.CSRC_DIR, root,
                                              kind.name(v), v)
    built = build_all(kernels, kind, variants)

    dev = torch.device("cuda")
    results = []
    for (kname, launch_name), case, plain in kind.cases(torch, np, dev):
        want = plain()
        runs = {}
        for name in variants:
            entries, rep = built[(name, kname)]
            row = {"kernel": kname, "launch": launch_name, "variant": name,
                   **rep}
            results.append(row)
            if rep.get("spill_bytes"):
                continue
            fn, out = kind.launch(torch, entries, kname, case)
            if fn is None:
                row["no_entry"] = True
                continue

            def run(fn=fn):
                rc = fn()
                if rc != 0:
                    raise RuntimeError(f"launch failed with CUDA error {rc}")
            try:
                run()
                torch.cuda.synchronize()
            except RuntimeError as e:  # reported in the row, not timed
                row["launch_error"] = str(e)
                continue
            outs = out if isinstance(out, tuple) else (out,)
            wants = want if isinstance(want, tuple) else (want,)
            row["equal_to_plain"] = all(torch.equal(o, w)
                                        for o, w in zip(outs, wants))
            runs[name] = (run, row)
        order = list(runs)
        for rnd, seq in enumerate((order, order[::-1])):
            for name in seq:
                run, row = runs[name]
                run()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    run()
                stop.record()
                torch.cuda.synchronize()
                row[f"ms_round{rnd}"] = start.elapsed_time(stop) / args.reps
        for run, row in runs.values():
            row["ms"] = (row["ms_round0"] + row["ms_round1"]) / 2
            row["device_ms"] = device_ms(torch, run, args.reps)
            if hasattr(kind, "package_kernels"):
                row["device_ms_package"] = device_ms(
                    torch, run, args.reps, kind.package_kernels)
        del want
    for row in results:
        print(json.dumps({**row, "card": smi}), flush=True)
    print(f"{'kernel':<27}{'launch':<10}{'variant':<17}{'regs':>5}"
          f"{'spill':>6}{'sass':>6}{'ms':>9}{'device_ms':>11}  equal")
    for r in results:
        ms = f"{r['ms']:.4f}" if "ms" in r else "-"
        dms = (f"{r['device_ms']:.5f}" if r.get("device_ms") is not None
               else "-")
        print(f"{r['kernel']:<27}{r['launch']:<10}{r['variant']:<17}"
              f"{str(r.get('registers')):>5}{str(r.get('spill_bytes')):>6}"
              f"{str(r.get('sass')):>6}{ms:>9}{dms:>11}  "
              f"{r.get('equal_to_plain')}  {r.get('launch_error', '')}")
    print(smi)
    bad = [r for r in results
           if r.get("equal_to_plain") is False or "launch_error" in r]
    if bad:
        print(f"{len(bad)} variant(s) failed or differ from the plain "
              "version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
