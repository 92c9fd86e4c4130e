#!/usr/bin/env python3
"""Sweep the masked point add's launch shape on one card.

Builds the point-add kernels, K2 (csrc/point_add.cu, 16-bit limbs) and K5
(csrc/point_add8.cu, 8-bit limbs in float32), from scratch copies of the
sources, one copy per body and launch shape (point.cuh AddShape): the
unrolled or the rolled body, and block size x minimum blocks per SM, the
`__launch_bounds__` pair that caps registers at 65,536 / (block x
blocks). Each build reports ptxas' registers and spill bytes and the SASS
counts of `cuobjdump -sass`; a build that spills is reported and not
timed. Every other build is checked bit for bit against the plain version
and timed with CUDA events, all variants of one launch in turns (forward,
then backward), on the widest launch of each kernel's path, with seeded
canonical operands of that shape:
- scan: 532,480 lanes reading one frontier at i and i - 1, 97 % of the
  lanes adding (the scan's level 0, one k=14 batch);
- forest: 266,240 lanes gathering pairs from a 524,288-lane frontier, no
  mask (the forest's level 0).

--parent DIR adds another version's csrc/ directory as a variant, built
and timed as it stands, to compare two versions on one card in one call.

Prints one JSON line per variant and launch, then the table and the
card's name and power limit. Needs a CUDA card.

Usage: python3 sweep_point_add.py [--reps N] [--parent DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SCAN_LANES = 532480
FOREST_LANES = 266240
FOREST_FRONTIER = 524288
ACTIVE_SHARE = 0.97
# (block size, minimum blocks per SM): no cap, then caps of 168 and 128
SHAPES = ((64, 1), (64, 6), (64, 8), (128, 1), (128, 3), (128, 4),
          (256, 1), (256, 2), (512, 1))
BODIES = ("unrolled", "rolled")
# point.cuh's AddShape fields, set alike for both formats in a variant
FIELDS = {"kThreads": r"static constexpr int kThreads = \d+;",
          "kMinBlocks": r"static constexpr int kMinBlocks = \d+;",
          "kRolled": r"static constexpr bool kRolled = (?:true|false);"}
SOURCES = {"point_add": "point_add.cu", "point_add8": "point_add8.cu"}


def make_variant(csrc, root, name, body=None, shape=None):
    """Copy csrc into root/name/csrc; with a body and shape, set
    point.cuh's AddShape fields for both limb formats (it must hold them
    as in this checkout)."""
    dst = os.path.join(root, name, "csrc")
    shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
    shutil.copytree(csrc, dst)
    if shape is not None:
        path = os.path.join(dst, "point.cuh")
        with open(path) as f:
            text = f.read()
        values = {"kThreads": f"int kThreads = {shape[0]};",
                  "kMinBlocks": f"int kMinBlocks = {shape[1]};",
                  "kRolled": f"bool kRolled = "
                             f"{'true' if body == 'rolled' else 'false'};"}
        for field, pattern in FIELDS.items():
            text, n = re.subn(pattern, "static constexpr " + values[field],
                              text)
            if n != 2:
                raise RuntimeError(f"point.cuh no longer holds AddShape's "
                                   f"{field} for both formats")
        with open(path, "w") as f:
            f.write(text)
    return dst


def build_all(kernels, variants):
    """kernels.build_report of both sources for every variant, the
    variants' builds all started together; returns {(variant, kernel):
    (C entry, report)}."""
    sources = tuple(SOURCES.values())

    def one(src_dir):
        out_dir = os.path.join(os.path.dirname(src_dir), "build")
        report = kernels.build_report(src_dir, out_dir, sources)
        return report, kernels.build(src_dir, out_dir, sources)

    with ThreadPoolExecutor(len(variants)) as ex:
        done = dict(zip(variants, ex.map(one, variants.values())))
    built = {}
    for name, (report, libs) in done.items():
        for kname, src in SOURCES.items():
            (label, rep), = report[src].items()
            entry = getattr(kernels.bind(libs[src][0], src), f"h2v_{kname}")
            built[(name, kname)] = (entry, {"kernel": label, **rep})
    return built


def cases(torch, np, f8, dev):
    """{(kernel, launch): (p, q, mask, iL, iR)} with seeded canonical
    operands: the u16 frontier and its 8-bit-limb copy."""
    from halo2_verifier_tpu_torch.ops.constants import P

    rng = np.random.default_rng(5)

    def frontier(width):
        coords = []
        for _ in range(3):
            limbs = rng.integers(0, 1 << 16, size=(16, width), dtype=np.int64)
            limbs[15] = rng.integers(0, P >> 240, size=width)
            coords.append(torch.from_numpy(limbs.astype(np.int32)).to(dev))
        return tuple(coords)

    scan16 = frontier(SCAN_LANES)
    scan8 = tuple(f8.expand16_to8(c) for c in scan16)
    i = torch.arange(SCAN_LANES, dtype=torch.int32, device=dev)
    partner = (i - 1).clamp_(min=0)
    mask = torch.from_numpy(rng.random(SCAN_LANES) < ACTIVE_SHARE).to(dev)
    mask[0] = False
    forest = frontier(FOREST_FRONTIER)
    j = torch.arange(FOREST_LANES, dtype=torch.int32, device=dev)
    iL = (2 * j) % FOREST_FRONTIER
    iR = (2 * j + 1) % FOREST_FRONTIER
    return {
        ("point_add", "scan"): (scan16, scan16, mask, None, partner),
        ("point_add8", "scan"): (scan8, scan8, mask, None, partner),
        ("point_add", "forest"): (forest, forest, None, iL, iR),
    }


def launch(torch, fn, rows, dtype, args):
    p, q, mask, iL, iR = args
    b = iL.shape[0] if iL is not None else iR.shape[0]
    out = torch.empty((3, rows, b), dtype=dtype, device=p[0].device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run():
        rc = fn(*(c.data_ptr() for c in p), p[0].shape[1],
                *(c.data_ptr() for c in q), q[0].shape[1], ptr(iL), ptr(iR),
                None if mask is None else mask.view(torch.uint8).data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), b,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
    return run, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", help="another version's csrc/ directory")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sweep_point_add: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from halo2_verifier_tpu_torch.ops import curve, field8 as f8, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    root = os.path.join(kernels.BUILD_DIR, "sweep")
    variants = {}
    if args.parent:
        variants["parent"] = make_variant(args.parent, root, "parent")
    for body in BODIES:
        for block, blocks in SHAPES:
            name = f"{body}_{block}x{blocks}"
            variants[name] = make_variant(kernels.CSRC_DIR, root, name, body,
                                          (block, blocks))
    built = build_all(kernels, variants)

    dev = torch.device("cuda")
    work = cases(torch, np, f8, dev)
    results = []
    for (kname, path), case in work.items():
        ops = curve.OPS8 if kname == "point_add8" else curve.OPS16
        rows = 32 if kname == "point_add8" else 16
        dtype = torch.float32 if kname == "point_add8" else torch.int32
        p, q, mask, iL, iR = case
        want = ops.masked_add_plain(p, q, mask, iL, iR)
        runs = {}
        for name in variants:
            entry, rep = built[(name, kname)]
            row = {"kernel": kname, "launch": path, "variant": name, **rep}
            results.append(row)
            if rep.get("spill_bytes"):
                continue
            run, out = launch(torch, entry, rows, dtype, case)
            try:
                run()
                torch.cuda.synchronize()
            except RuntimeError as e:  # reported in the row, not timed
                row["launch_error"] = str(e)
                continue
            row["equal_to_plain"] = all(torch.equal(o, w)
                                        for o, w in zip(out, want))
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
        del want
    for row in results:
        print(json.dumps({**row, "card": smi}), flush=True)
    print(f"{'kernel':<27}{'launch':<8}{'variant':<17}{'regs':>5}"
          f"{'spill':>6}{'sass':>6}{'ms':>9}  equal")
    for r in results:
        ms = f"{r['ms']:.4f}" if "ms" in r else "-"
        print(f"{r['kernel']:<27}{r['launch']:<8}{r['variant']:<17}"
              f"{str(r.get('registers')):>5}{str(r.get('spill_bytes')):>6}"
              f"{str(r.get('sass')):>6}{ms:>9}  {r.get('equal_to_plain')}"
              f"  {r.get('launch_error', '')}")
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
