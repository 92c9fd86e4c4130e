#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (halo2_verifier_tpu_torch) on one card.

Phases, one output line each (JSON unless noted):
1. the card: `nvidia-smi` name and power limit, torch's device name;
2. build: every CUDA kernel from the sources in this checkout (nvcc, one
   process per source, started together), with ptxas' registers and spill
   bytes and the SASS that `cuobjdump -sass` shows (the static instruction
   count and the classes that explain the bound) per kernel; a spill, or a
   missing cuobjdump, fails the phase;
3. parity on the card, bit for bit, at main-path widths: the Montgomery
   multiply (Fq and Fr, 16,384 and 2^19 lanes, random plus adversarial
   operands), the point add at the forest's level-0 width with fused
   gathers (random, identity, P+P and P+(-P) pairs, masked lanes, two
   rounds so general projective inputs are covered, then off-curve
   triples of the carry chains' edge values, masked and unmasked), the
   square root at 15,360 and 16,384 lanes against the plain version (and
   at 16,384 against the loop of Montgomery-multiply launches), edge x
   values included (0, 1, q - 1, q - 2^32, x^3 + 3 a non-residue); the
   level-0 frontier on phase 4's plan (532,480 lanes from 17,408 points:
   the plan's repeated indices, (0, 0) points and the identity pad);
   at scan widths: the doubling at 2^19 lanes (random points, identities,
   outputs of an earlier add; the edge triples at 1, 33 and 2^19 lanes,
   their outputs doubled again), the 8-bit-limb Montgomery multiply (Fq and
   Fr, 16,384 and 532,480 lanes) and the 8-bit-limb point add at 532,480
   lanes on the point add's cases and edge triples; across formats, 2P
   against P + P as
   affine points and every 8-bit-limb output against the re-limbed
   16-bit-limb kernel's; the 8-bit-limb outputs' range; the device
   pairing's tower kernels (Fq add/sub/neg, the fused Fq12 multiply and
   square, the Fermat inversion for Fq and Fr,
   the Miller step in both modes) at the pairing's widths and at 16,384
   lanes, with edge operands; the
   device pairing check: Miller lanes against the host oracle, good and
   tampered verdicts against the host pairing, its time beside the host
   pairing's, launches per check by kernel (held to the counts of the
   dispatch), the profiler's count of device kernels in one check, its
   device busy time and device time per launch;
4. one forest MSM and one scan MSM per limb backend of a main-path batch's
   size (16,640 random scalars and points in groups of 1,024 and 15,616)
   against the exact host MSM, the f8 window totals bit-equal to the
   re-limbed u16 totals; the forest's dispatch at that size
   (packed_parity): four pinned batches through one slot of recordings,
   a re-pin among them, each batch's points equal to the host MSM's (the
   first's totals bit-equal to the same chain's on the CPU) and its
   launches, counted through the replays, those its layout gives (L + 23),
   each recording's graph nodes its launches and one copy;
5. the main paths, each with every kernel's launch count set to 0 just
   before and read just after, and each refused if a kernel outside its
   list launched or one on it did not: BatchVerifier.verify_stream over
   streamed batches of 1,024 k=14 mac_range proofs (the committed pack
   tiled, as bench.py does), every batch ok, through the VM fast path,
   with the forest MSM (the frontier, point-add and square-root kernels;
   no Montgomery multiply; plan widths pinned, one packed upload, the
   chain recorded once per pinned signature and replayed; each forest
   stream's line gives its device_msm_dispatch per batch split into its
   parts, its recordings, replays and re-pins and the recordings' memory
   pool), then with msm="scan" in "u16" (8 batches) and "f8" (4);
   for the forest and the scan, a 64-proof batch with one public input
   changed by +1, which must fail at that index; the doubling through its
   public entry, ops/curve.double (no verifier path doubles on the
   device, in either package); the forest stream once more with
   pairing="device" (8 batches; K1, T1, the fused Fq12 multiply, T3 and
   the Miller step join the forest's kernels), its tampered 64-proof
   batch, and strategy="single" with the device pairing on 8 proofs, one
   tampered (only K1, T1, the Fq12 multiply, T3 and the Miller step
   launch: the single strategy's
   MSMs run on the host); the limb-minor layer
   (minor_path: ops/field_minor.py and ops/curve_minor.py on (..., 16)
   limbs, which no verifier path runs): mont_mul, add and sub on Fq and
   Fr at (2, 266,240, 16), the curve add at 266,240 lanes, the doubling
   at 524,288, inv_mont and to_affine_batch at 16,640 and pow_fixed with
   (p+1)/4 at 15,360, each call's launches held to its kernels (one K1
   per mont_mul, one K2 per add, one K3 per double), each result to its
   plain version, to the limbs-major kernels on the transposed inputs
   and, on 64 lanes, to the host oracle; each function timed whole and
   its transposes apart from its kernels (launches_minor_path);
   bench.py's two k=9 configurations at its sizes (7 batches of 256),
   their keys derived by the port's prover (prover/keygen.py) from the
   tracked k=9 SRS and checked against the committed packs' vk hashes:
   keccak256 x GWC mac_range proofs (keccak_gwc_path, then
   tampered_batch_keccak_gwc) and mac_range and vector_mul proofs
   alternating in each batch under vk=None (hetero_vk_path, then
   tampered_batch_hetero_vk, the tampered proof a vector_mul one), each
   with the forest's kernels alone; the verify command (cli_path): the
   port's CLI in this process on files it writes (convert-params' params,
   the vk, a keccak256 x GWC and a blake2b x SHPLONK proof), OK and 0 with
   the forest's kernels, FAIL and 1 on four probes (tampered instances,
   the wrong hash, the wrong multiopen, a truncated proof), and once as a
   subprocess on the card, exit 0; each kernel's row gives its launches
   on these paths (launches_k9_paths);
   the mesh (parallel/mesh.py), whose sharded MSMs keep host
   decompression (no sqrt launch), on the one card: mesh_path, a process
   group of one NCCL rank in this process: phase 4's batch-sized MSM in
   the window-sharded and the point-sharded forest (its all_to_all on
   NCCL), each rank's totals bit-equal to the single-device forest's and
   the points to the host MSM's, then BatchVerifier(mesh=...) over 8
   streamed batches of 1,024 k=14 proofs (every batch ok, the frontier
   and point-add kernels alone) and the tampered 64-proof batch;
   mesh_ranks_path, four gloo ranks on cuda:0 (this script run as a rank,
   `--mesh-rank R`, in four subprocesses after the build): the same MSM
   in the windows, forest and scan (u16) kinds, each rank's launches
   counted per kind (the frontier and point add on the forest kinds, the
   Montgomery multiply and point add on the scan), rank 0 holding the
   windows kind's totals to the single-device forest's bit for bit and
   every kind's points to the host MSM's, then a 4-batch stream and the
   tampered batch on every rank; its rate is four ranks sharing one
   card, collectives through host memory: a check of the launch path,
   not a multi-card rate; each kernel's row gives its launches there
   (launches_mesh_paths);
6. kernel timings on the arguments of each kernel's widest launch on its
   path (the wrappers keep them), each the profiler's device time per
   launch (CUDA events around 20 calls beside it), beside the plain
   version and the bound,
   and the square root also at 32 lanes (one warp: one chain's latency),
   K1 also at the device pairing's widest launch;
   the whole device stage of phase 4's batch-sized forest (on the pinned
   plan, replayed) and scans; the
   device busy share of a profiled stream on the warm verifier, whose
   trace must hold as many frontier and point-add events as their
   wrappers counted (1 and 30 per batch, through the replays).

The line before the last holds the kernels' record and the one before it
the `nvidia-smi` text; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero; without a CUDA card the script prints no
result and exits 2, and without the package beside it, 3.

Usage: python3 chip_smoke.py [--batches N]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

BATCH = 1024
TAMPER_BATCH = 64
TAMPER_INDEX = 37
MONT_MUL_WIDTHS = (16384, 1 << 19)  # decomp width, and a wide one
POINT_ADD_WIDTH = 524288            # the forest's level-0 frontier
POINT_ADD_NARROW_WIDTH = 12288      # a forest level in the narrow shape
# the K2 row's narrow widths: a Horner step, the last fold, a deep level,
# the widest fold below the narrow shape's threshold
POINT_ADD_TIMED_WIDTHS = (64, 512, 4096, 16384)
SQRT_WIDTHS = (15360, 16384)        # 15 points x 1,024 proofs; padded
FOREST_SIZES = (1024, 15616)       # one main-path batch's two MSM groups
SCAN_LANES = sum(FOREST_SIZES) * 32  # (entry, window) lanes of one batch
POINT_DOUBLE_WIDTH = 524288
MINOR_FIELD_SHAPE = (2, 266240)     # the u16 scan's K1 width, 532,480 lanes
MINOR_ADD_WIDTH = 266240            # the limb-minor point add's lanes
MINOR_INV_WIDTH = 16640             # one batch's MSM entries
MINOR_POW_WIDTH = 15360             # the sqrt pre-pass's lanes
MINOR_SAMPLE = 64                   # lanes per function held to the host
MONT_MUL8_WIDTHS = (16384, SCAN_LANES)
SCAN_BATCHES = {"u16": 8, "f8": 4}
K9_BATCH = 256                       # bench.py run_extras' defaults
K9_BATCHES = 7                       # (H2V_BENCH_EXTRA_BATCH, _BATCHES)
FOREST_KERNELS = ("forest_frontier0", "point_add", "sqrt_principal")
# the forest's launches per main-path batch, one chain (9 levels, the
# deepest part's scatter, 7 folds, 14 Horner steps), and a
# piece of each kernel's name in a profiler trace
FOREST_PER_BATCH = {"forest_frontier0": 1, "point_add": 31}
FOREST_TRACE_NAMES = {"forest_frontier0": "frontier0_kernel",
                      "point_add": "point_add_kernel<h2v::Limbs16>"}
# the forest dispatch's parts, as the orchestrator times them inside
# device_msm_dispatch (msm_forest.dispatch_planned)
DISPATCH_PARTS = ("dispatch_plan", "dispatch_check", "dispatch_pack",
                  "dispatch_h2d", "dispatch_launch", "dispatch_record",
                  "dispatch_prefetch")
MESH_KERNELS = ("forest_frontier0", "point_add")  # host decompression
MESH_BATCHES = 8                     # the NCCL world of one
MESH_RANKS = 4                       # gloo ranks sharing the card
MESH_RANK_BATCHES = 4
MESH_RANKS_LABEL = ("{ranks} ranks sharing one {card}, collectives through "
                    "host memory (gloo)")
MESH_RANK_TIMEOUT_S = 600
HERE = os.path.dirname(os.path.abspath(__file__))
TOWER_WIDTHS = (1, 2, 16384)         # the pairing's widths (two live pairs)
DEVICE_PAIRING_BATCHES = 8            # the paced rate spans 5 intervals
SINGLE_PROOFS = 8
SINGLE_TAMPER_INDEX = 5
PAIRING_REPS = 5                     # checks timed, median reported
# kernel launches of one device pairing check of two live pairs, as the
# dispatch counts them (tests/test_torch_fq12_fused.py)
PAIRING_LAUNCHES = {"mont_mul": 13, "fq_addsub": 501, "fq12_mul": 1318,
                    "fq_inv": 1, "miller_step": 102}

# Bound model: the least time of an operation count is the longest of the
# SM's pipes that must run it (NVIDIA CUDA C++ Programming Guide,
# arithmetic instruction throughput for compute capability 9.0; Hopper
# architecture white paper): per SM and clock, 64 32-bit integer
# multiply-adds (FMA pipe), 64 other 32-bit integer operations (adds,
# selects, byte permutes: ALU pipe), and 128 instructions issued in all
# (4 schedulers x one 32-lane warp instruction), FP32 operations included;
# at the SM clock nvidia-smi reports as the maximum. Bytes: 3.35 TB/s
# (H100 SXM data sheet). Counts are (multiply-adds, ALU operations, FP32
# operations), the least the function needs on 32-bit words: a CIOS
# Montgomery product is 128 word products of 2 multiply-adds each with
# fused carry chains (PTX mad.lo.cc + madc.hi.cc) and 8 reduction factors
# (264), and a conditional subtract of 16 ALU operations (an 8-word
# subtract chain, 8 selects); a modular add or subtract is 24 (an 8-word
# carry chain, an 8-word chain for the modulus, 8 selects). Moving an
# element between limbs and words: 16-bit limbs load with one byte_perm
# per word (8) and store with a mask and a shift per word (16); 8-bit
# limbs in float32 load with one byte_perm per word (8) and store with one
# per byte (32), their float halves and bytes made by 32 FP32 operations
# each way (csrc/field.cuh Limbs8). An exact linear map with small integer
# coefficients (ops_linmap): per output a coefficient of +-1 is an 8-word
# add or subtract (8 ALU operations; the output's first term is free), any
# other one element times a small scalar accumulated (8 word products of 2
# multiply-adds), and one reduction (a quotient's product with the
# modulus, 16 multiply-adds, and a conditional subtract); an output that
# is one of its operands copies it and costs nothing; an exponentiation by
# a constant: the shortest fixed-window chain for it (ops/decomp.py
# window_chain_counts).
IMAD_PER_SM_CLK = 64
ALU_PER_SM_CLK = 64
ISSUE_PER_SM_CLK = 128
HBM_BYTES_PER_S = 3.35e12


def ops(*terms):
    """The sum of (count, (multiply-adds, ALU, FP32)) terms."""
    return tuple(sum(n * v[i] for n, v in terms) for i in range(3))


MONT_MUL = (128 * 2 + 8, 16, 0)
# a squaring: 36 word products for a^2 (28 cross products, doubled, and 8
# on the diagonal), 64 + 8 for the reduction
MONT_SQR = ((36 + 64) * 2 + 8, 16, 0)
ADD_SUB = (0, 24, 0)
SCALAR_MAD = (8 * 2, 0, 0)
ADD8 = (0, 8, 0)
LINMAP_REDUCE = (8 * 2, 16, 0)
LOAD16, STORE16 = (0, 8, 0), (0, 16, 0)
LOAD8, STORE8 = (0, 8, 32), (0, 32, 32)
# doubling (RCB15 alg. 9) at its least work: the squares Y^2 and Z^2, six
# other products, less the reduction that Y3 = t2 z3 + t0m y3 saves by
# summing its two products before one reduction (64 word products of 2
# multiply-adds, 8 factors, a conditional subtract), and 12 adds or
# subtracts (8 t0 by three doublings, 9 Z^2 by four adds, y3, 3 t2 and
# t0 - 3 t2, 2 X3); 3 loads and 3 stores: 1,864 multiply-adds.
SHARED_REDC = (-(64 * 2 + 8), -16, 0)
OPS_POINT_DOUBLE = ops((2, MONT_SQR), (6, MONT_MUL), (1, SHARED_REDC),
                       (12, ADD_SUB), (3, LOAD16), (3, STORE16))


def ops_linmap(M):
    """(multiply-adds, ALU, FP32) of the exact linear map M (n_out, k) on
    one lane, as the bound model above counts it."""
    terms = []
    for row in M:
        nz = row[row != 0]
        if len(nz) == 1 and nz[0] == 1:
            continue  # a copy
        scaled = int((abs(nz) > 1).sum())
        unit = len(nz) - scaled
        terms += [(scaled, SCALAR_MAD), (unit - (scaled == 0), ADD8),
                  (1, LINMAP_REDUCE)]
    return ops(*terms)


def inv_chain_counts(e):
    """(squarings, multiplies) of the fixed-window chain for e with the
    fewest multiply-adds, over windows of 1 to 8 bits."""
    from halo2_verifier_tpu_torch.ops.decomp import window_chain_counts

    return min((window_chain_counts(e, w) for w in range(1, 9)),
               key=lambda c: ops((c[0], MONT_SQR), (c[1], MONT_MUL))[0])


def ops_miller_step(mode):
    """(multiply-adds, ALU, FP32) of one Miller step on one lane, as the
    kernel's formulas need them (csrc/tower.cu miller_step_kernel): T3's
    chain (inv_chain_counts), the norm's two squarings and 17 other
    products when doubling (x^2 2, num conj(den) 3, lambda 2, lambda^2 2,
    lambda xt 3, lambda (xt - x3) 3, lambda px 2), 15 when adding (no x^2);
    40 modular adds and subtracts when doubling, 35 when adding."""
    from halo2_verifier_tpu_torch.ops.constants import P

    squarings, multiplies = inv_chain_counts(P - 2)
    double = mode == 0
    return ops((squarings + 2, MONT_SQR),
               (multiplies + (17 if double else 15), MONT_MUL),
               (40 if double else 35, ADD_SUB))


def ops_sqrt(squarings, multiplies):
    """Square root: the chain the kernel runs (ops/decomp.py
    sqrt_chain_counts: with its 4-bit window 250 squarings and 72
    products, the three of x^3 and the one out of Montgomery form
    included); one add; one load, one store."""
    return ops((squarings, MONT_SQR), (multiplies, MONT_MUL), (1, ADD_SUB),
               (1, LOAD16), (1, STORE16))


LIMB_BYTES = 16 * 4  # one element, (16,) int32 limbs
LIMB_BYTES8 = 32 * 4  # one element, (32,) float32 limbs
FORMAT = {  # kernel -> (bytes per element, ops to load one, ops to store)
    "mont_mul": (LIMB_BYTES, LOAD16, STORE16),
    "forest_frontier0": (LIMB_BYTES, LOAD16, STORE16),
    "point_add": (LIMB_BYTES, LOAD16, STORE16),
    "mont_mul8": (LIMB_BYTES8, LOAD8, STORE8),
    "point_add8": (LIMB_BYTES8, LOAD8, STORE8),
}


def out(obj):
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


class Card:
    """The card's identity and the rates its bound uses."""

    def __init__(self, torch):
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        self.smi = q.stdout.strip().splitlines()[0]
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60)
        self.sm_mhz = float(clk.stdout.strip().splitlines()[0])
        props = torch.cuda.get_device_properties(0)
        self.name = torch.cuda.get_device_name(0)
        self.sms = props.multi_processor_count
        self.sm_clk_per_s = self.sms * self.sm_mhz * 1e6
        self.power_limit = self.smi.split(",")[-1].strip()

    def tag(self):
        return {"card": self.name, "power_limit": self.power_limit}

    def bound(self, nbytes, counts):
        """The least ms for nbytes and (multiply-adds, ALU, FP32) counts,
        and which of the two bounds it."""
        imad, alu, fp32 = counts
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(imad / IMAD_PER_SM_CLK, alu / ALU_PER_SM_CLK,
                    (imad + alu + fp32) / ISSUE_PER_SM_CLK
                    ) / self.sm_clk_per_s * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps, warmup=1):
    """Mean milliseconds of fn() on the card by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, kernel, reps=20):
    """Mean device milliseconds per launch of the CUDA function whose name
    holds `kernel`, over `reps` back-to-back calls of fn, from the
    profiler's kernel events (CUDA events around launches this short time
    the host's dispatch, not the kernel); None where the profiler shows no
    such launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(ev) / len(ev) / 1e3 if ev else None


def sig(x):
    """x to four significant digits (a bound of a few lanes' work is
    far below 0.0001 ms)."""
    return float(f"{x:.4g}")


def max_abs_err(torch, got, want):
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def kernel_counts(kernels, counts):
    """A dict of launch counts by kernel without the counters that count
    a part of another kernel's launches (kernels.PART_COUNTERS)."""
    return {k: v for k, v in counts.items() if k not in kernels.PART_COUNTERS}


# ---------------------------------------------------------------- phases

def phase_build(kernels):
    """Every kernel built, with ptxas' registers and spill bytes and its
    SASS counts (kernels.build_report); fails on a spill."""
    t0 = time.time()
    report = kernels.build_report()
    spilled = [f"{src} {k}" for src, ks in report.items()
               for k, r in ks.items() if r.get("spill_bytes") != 0]
    if spilled:
        raise AssertionError(f"build: spills in {spilled}")
    return {"phase": "build", "seconds": round(time.time() - t0, 3),
            "kernels": report}


def random_field(np, rng, modulus, n):
    """n canonical elements as (n, 16) uint32 limbs: random limbs, the top
    one kept below the modulus' top limb."""
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] = rng.integers(0, modulus >> 240, size=n, dtype=np.uint32)
    return limbs


def phase_k1(torch, np, fm, ints_to_limbs, dev):
    from halo2_verifier_tpu_torch.ops.constants import FOLD_EDGE, P

    adversarial = [0, 1, 2, (1 << 16) - 1, (1 << 255) % P, P - 1, P - 2,
                   (P + 1) // 2, 0xFFFF_FFFF_FFFF_FFFF]
    rng = np.random.default_rng(1)
    worst = 0
    checked = []
    for spec in (fm.FQ, fm.FR):
        for width in MONT_MUL_WIDTHS:
            a = random_field(np, rng, spec.modulus, width)
            b = random_field(np, rng, spec.modulus, width)
            adv = [v % spec.modulus for v in adversarial]
            a[:len(adv)] = ints_to_limbs(adv)
            b[len(adv):2 * len(adv)] = ints_to_limbs(adv)
            if spec is fm.FQ:  # the fold of m at its edge
                a[-3:] = ints_to_limbs([x for x, _ in FOLD_EDGE])
                b[-3:] = ints_to_limbs([y for _, y in FOLD_EDGE])
            A = torch.from_numpy(a.T.astype(np.int32).copy()).to(dev)
            B = torch.from_numpy(b.T.astype(np.int32).copy()).to(dev)
            got = fm.mont_mul(A, B, spec)
            want = fm.mont_mul_body(A.long(), B.long(), spec).int()
            err = max_abs_err(torch, got, want)
            worst = max(worst, err)
            checked.append([spec.kernel_id, width, err])
    return {"phase": "parity_mont_mul", "tolerance": 0,
            "max_abs_err": worst, "checked": checked}


def curve_points(hc, G, n, seed):
    """n affine points: consecutive multiples of a random point."""
    import random

    step = hc.g1_mul(G, random.Random(seed).randrange(1, 1 << 128))
    pts = [step]
    for _ in range(n - 1):
        pts.append(hc.g1_add(pts[-1], step))
    return pts


def mont_points(torch, np, ints_to_limbs, fm, curve, pts, dev):
    from halo2_verifier_tpu_torch.ops.constants import P

    r = fm.FQ.mont_r
    xs = [0 if p is None else p[0] * r % P for p in pts]
    ys = [0 if p is None else p[1] * r % P for p in pts]

    def up(v):
        return torch.from_numpy(
            ints_to_limbs(v).T.astype(np.int32).copy()).to(dev)

    return curve.from_affine(up(xs), up(ys))


def add_case(torch, np, hc, fm, curve, ints_to_limbs, dev, width):
    """The point add's inputs at `width` lanes: a frontier of real points
    P_i, -P_i and identities, gathered by random indices with P+P,
    P+(-P), identity+identity and identity+P lanes forced, and a mask.
    Returns (frontier, iL, iR, mask, pool) with the pool's host points."""
    from halo2_verifier_tpu_torch.ops.constants import G1_GEN

    base = curve_points(hc, G1_GEN, 2048, 7)
    pool = base + [hc.g1_neg(p) for p in base] + [None] * 64
    src = mont_points(torch, np, ints_to_limbs, fm, curve, pool, dev)
    n = len(pool)
    reps = -(-width // n)
    f = tuple(c.repeat(1, reps)[:, :width].contiguous() for c in src)
    g = torch.Generator(device="cpu").manual_seed(3)
    iL = torch.randint(0, width, (width,), generator=g, dtype=torch.int32)
    iR = torch.randint(0, width, (width,), generator=g, dtype=torch.int32)
    k = width // 8
    iR[:k] = iL[:k]                                   # P + P
    lanes = torch.arange(k, 2 * k, dtype=torch.int32)
    iL[k:2 * k] = lanes % 2048                        # P_j (one tile in)
    iR[k:2 * k] = lanes % 2048 + 2048                 # + (-P_j)
    iL[2 * k:3 * k] = 4096 + lanes % 64               # identity
    iR[2 * k:3 * k] = torch.where(lanes % 2 == 0, 4096 + lanes % 64,
                                  lanes % 4096)       # + identity / + P
    mask = torch.rand(width, generator=g) < 0.9
    mask[:3 * k] = True
    return f, iL.to(dev), iR.to(dev), mask.to(dev), pool


def edge_case(torch, np, fm, ints_to_limbs, dev, width):
    """Off-curve triples of the carry chains' edge values (constants.
    fq_edge_triples, every value in every coordinate), each once masked
    and once not, in the first lanes of `width` lanes of random canonical
    triples: (p, q, mask, edge lanes)."""
    from halo2_verifier_tpu_torch.ops.constants import fq_edge_triples

    triples = fq_edge_triples(range(15))
    edge = 2 * len(triples)
    rng = np.random.default_rng(6)
    coords = []
    for c in range(6):
        limbs = random_field(np, rng, fm.FQ.modulus, width)
        limbs[:edge] = ints_to_limbs([t[c] for t in triples] * 2)
        coords.append(torch.from_numpy(
            limbs.T.astype(np.int32).copy()).to(dev))
    mask = torch.from_numpy(rng.random(width) < 0.9)
    mask[:len(triples)] = True
    mask[len(triples):edge] = False
    return tuple(coords[:3]), tuple(coords[3:]), mask.to(dev), edge


def phase_k2(torch, np, hc, fm, curve, ints_to_limbs, dev, width):
    """The point add at the forest's level-0 width: the point add's
    cases with fused gathers, then the edge triples."""
    f, iL, iR, mask, _pool = add_case(torch, np, hc, fm, curve,
                                      ints_to_limbs, dev, width)
    worst = 0
    p = f
    for _ in range(2):  # round 2 adds general projective points
        got = curve.masked_add(p, p, mask, iL, iR)
        want = curve.masked_add_plain(p, p, mask, iL, iR)
        worst = max(worst, max_abs_err(torch, got, want))
        p = got
    p, q, emask, edge = edge_case(torch, np, fm, ints_to_limbs, dev, width)
    err_edge = max_abs_err(torch, curve.masked_add(p, q, emask),
                           curve.masked_add_plain(p, q, emask))
    return {"phase": "parity_point_add", "tolerance": 0, "lanes": width,
            "max_abs_err": max(worst, err_edge),
            "max_abs_err_edge_triples": err_edge, "edge_lanes": edge}


def check_limbs8(torch, name, *ts):
    """The 8-bit-limb kernels' contract on their outputs: integers in
    [0, 255]."""
    for t in ts:
        if (t.dtype != torch.float32 or float(t.min()) < 0
                or float(t.max()) > 255 or not torch.equal(t, t.floor())):
            raise AssertionError(f"{name}: output limbs are not integers "
                                 "in [0, 255]")


def phase_k3(torch, np, hc, fm, curve, ints_to_limbs, dev, width):
    """The doubling at `width` lanes: random points, negatives and
    identities, then outputs of an earlier add (general Z); then off-curve
    triples, the edge triples (constants.double_edge_triples) in the first
    lanes of random canonical ones, at 1, 33 and `width` lanes, each
    doubled and its output doubled again. Across kernels: 2P and the add
    kernel's P + P are the same affine points."""
    from halo2_verifier_tpu_torch.ops.constants import double_edge_triples

    f, iL, iR, _mask, pool = add_case(torch, np, hc, fm, curve,
                                      ints_to_limbs, dev, width)
    worst = 0
    for p in (f, curve.masked_add(f, f, iL=iL, iR=iR)):
        got = curve.double(p)
        worst = max(worst, max_abs_err(torch, got, curve.double_plain(p)))
    edge = double_edge_triples()
    rng = np.random.default_rng(4)
    coords = []
    for c in range(3):
        limbs = random_field(np, rng, fm.FQ.modulus, width)
        limbs[:len(edge)] = ints_to_limbs([t[c] for t in edge])
        coords.append(torch.from_numpy(
            limbs.T.astype(np.int32).copy()).to(dev))
    by_width = {}
    for lanes in (1, 33, width):
        p = tuple(c[:, :lanes].contiguous() for c in coords)
        err = 0
        for _ in range(2):  # then the kernel's own output
            got = curve.double(p)
            err = max(err, max_abs_err(torch, got, curve.double_plain(p)))
            p = got
        by_width[str(lanes)] = err
    n = len(pool)
    head = tuple(c[:, :n].contiguous() for c in f)
    doubled = curve.to_affine_host(curve.double(head))
    same_point = (doubled == curve.to_affine_host(curve.add(head, head))
                  == [hc.g1_double(q) for q in pool])
    return {"phase": "parity_point_double", "tolerance": 0, "lanes": width,
            "max_abs_err": max(worst, *by_width.values()),
            "max_abs_err_edge_triples_by_lanes": by_width,
            "edge_lanes": len(edge),
            "double_equals_self_add_affine": same_point,
            "affine_points_checked": n}


def phase_k4(torch, np, fm, f8, ints_to_limbs, dev):
    """The 8-bit-limb Montgomery multiply, Fq and Fr, at the decomp width
    and the scan's conversion width, on random operands plus the
    adversarial ones of tests/test_lm8_kernels.py; against the plain
    float32 body and against the 16-bit-limb kernel's re-limbed output."""
    rng = np.random.default_rng(2)
    worst = worst_cross = 0
    checked = []
    for spec in (fm.FQ, fm.FR):
        mod = spec.modulus
        adv_a = [0, 1, mod - 1, mod - 2, (1 << 256) % mod,
                 ((1 << 256) - 1) % mod]
        adv_b = [0, mod - 1, mod - 1, 1, 2, ((1 << 255) - 1) % mod]
        for width in MONT_MUL8_WIDTHS:
            a = random_field(np, rng, mod, width)
            b = random_field(np, rng, mod, width)
            a[:len(adv_a)] = ints_to_limbs(adv_a)
            b[:len(adv_b)] = ints_to_limbs(adv_b)
            A16 = torch.from_numpy(a.T.astype(np.int32).copy()).to(dev)
            B16 = torch.from_numpy(b.T.astype(np.int32).copy()).to(dev)
            A, B = f8.expand16_to8(A16), f8.expand16_to8(B16)
            got = f8.mont_mul(A, B, spec)
            check_limbs8(torch, "mont_mul8", got)
            err = max_abs_err(torch, got, f8.mont_mul_body(A, B, spec))
            cross = max_abs_err(
                torch, got, f8.expand16_to8(fm.mont_mul(A16, B16, spec)))
            worst, worst_cross = max(worst, err), max(worst_cross, cross)
            checked.append([spec.kernel_id, width, err, cross])
    return {"phase": "parity_mont_mul8", "tolerance": 0,
            "max_abs_err": max(worst, worst_cross),
            "max_abs_err_vs_plain": worst,
            "max_abs_err_vs_relimbed_u16_kernel": worst_cross,
            "checked": checked}


def phase_k5(torch, np, hc, fm, f8, curve, ints_to_limbs, dev, width):
    """The 8-bit-limb point add at the scan's width on the point add's
    cases, fused gathers and mask, then on the edge triples: against the
    plain float32 version, and against the 16-bit-limb kernel's re-limbed
    output on the same points."""
    f16, iL, iR, mask, _pool = add_case(torch, np, hc, fm, curve,
                                        ints_to_limbs, dev, width)
    ops8 = curve.OPS8
    p16 = f16
    p8 = tuple(f8.expand16_to8(c) for c in f16)
    worst = worst_cross = 0
    for _ in range(2):  # round 2 adds general projective points
        got = ops8.masked_add(p8, p8, mask, iL, iR)
        check_limbs8(torch, "point_add8", *got)
        worst = max(worst, max_abs_err(
            torch, got, ops8.masked_add_plain(p8, p8, mask, iL, iR)))
        got16 = curve.masked_add(p16, p16, mask, iL, iR)
        worst_cross = max(worst_cross, max_abs_err(
            torch, got, tuple(f8.expand16_to8(c) for c in got16)))
        p8, p16 = got, got16
    p16, q16, emask, edge = edge_case(torch, np, fm, ints_to_limbs, dev,
                                      width)
    p8, q8 = (tuple(f8.expand16_to8(c) for c in x) for x in (p16, q16))
    got = ops8.masked_add(p8, q8, emask)
    check_limbs8(torch, "point_add8", *got)
    err_edge = max(
        max_abs_err(torch, got, ops8.masked_add_plain(p8, q8, emask)),
        max_abs_err(torch, got, tuple(
            f8.expand16_to8(c) for c in curve.masked_add(p16, q16, emask))))
    return {"phase": "parity_point_add8", "tolerance": 0, "lanes": width,
            "max_abs_err": max(worst, worst_cross, err_edge),
            "max_abs_err_vs_plain": worst,
            "max_abs_err_vs_relimbed_u16_kernel": worst_cross,
            "max_abs_err_edge_triples": err_edge, "edge_lanes": edge}


def phase_sqrt(torch, np, hc, fm, curve, ints_to_limbs, decomp, dev):
    """The square root at the main path's width and padded to 16,384:
    half curve points' x, half random canonical x (half of those off the
    curve), the edge values in the first lanes; against the plain
    version, and at 16,384 lanes also the loop of Montgomery-multiply
    launches. The edge lanes (constants.sqrt_edge_xs) also against pow on
    Python integers."""
    from halo2_verifier_tpu_torch.ops.constants import G1_GEN, P, sqrt_edge_xs
    from halo2_verifier_tpu_torch.ops.limbs import limbs_to_ints

    width = max(SQRT_WIDTHS)
    pts = curve_points(hc, G1_GEN, width // 2, 11)
    rng = np.random.default_rng(4)
    edge = sqrt_edge_xs()
    xs = np.concatenate([ints_to_limbs(edge),
                         ints_to_limbs([p[0] for p in pts]),
                         random_field(np, rng, fm.FQ.modulus,
                                      width // 2 - len(edge))])
    X = torch.from_numpy(xs.T.astype(np.int32).copy()).to(dev)
    checked, worst = [], 0
    for lanes in SQRT_WIDTHS:
        x = X[:, :lanes].contiguous()
        fused = decomp.y_principal(x)
        err = max_abs_err(torch, fused, decomp.y_principal_plain(x))
        if lanes == width:
            err = max(err, max_abs_err(torch, decomp.y_principal_k1(x),
                                       fused))
        worst = max(worst, err)
        checked.append([lanes, err])
    got = limbs_to_ints(fused[:, :len(edge)].cpu().numpy().T)
    if got != [pow((x ** 3 + 3) % P, (P + 1) // 4, P) for x in edge]:
        raise AssertionError("sqrt: edge lanes differ from pow")
    return {"phase": "parity_sqrt", "tolerance": 0, "lanes": list(SQRT_WIDTHS),
            "edge_lanes": len(edge), "max_abs_err": worst,
            "checked": checked}


def phase_frontier(torch, np, msm_forest, forest_inputs, dev):
    """The level-0 frontier kernel at the forest's widths, on phase 4's
    plan (every point gathered once per nonzero window digit; the identity
    pad's index) and points, a few of them set to (0, 0), against the
    plain version."""
    x_np, y_np, plan, _dev, _totals = forest_inputs
    xs, ys = msm_forest.pad_transpose_points(x_np, y_np, plan["n_pad"])
    xs[:, ::997] = 0  # identity points among the real ones
    ys[:, ::997] = 0
    X = torch.from_numpy(xs.view(np.int32)).to(dev)
    Y = torch.from_numpy(ys.view(np.int32)).to(dev)
    idx = torch.from_numpy(plan["point_idx0"]).to(dev)
    got = msm_forest.frontier0(X, Y, idx)
    err = max_abs_err(torch, got, msm_forest.frontier0_plain(X, Y, idx))
    pad = int((plan["point_idx0"] == plan["n_pad"] - 1).sum())
    zero = int(np.isin(plan["point_idx0"],
                       np.flatnonzero((xs == 0).all(0) & (ys == 0).all(0)))
               .sum())
    return {"phase": "parity_forest_frontier0", "tolerance": 0,
            "lanes": int(idx.shape[0]), "points": int(plan["n_pad"]),
            "identity_lanes": zero, "identity_pad_lanes": pad,
            "max_abs_err": err}


def phase_forest(torch, np, hc, msm_forest, msm, ints_to_limbs, dev):
    """Returns the phase line, the forest's device-stage inputs with its
    window totals, and the case (scalar limbs, point limbs, sizes, the
    host MSM's answers)."""
    from halo2_verifier_tpu_torch.ops.constants import G1_GEN, R

    sizes = list(FOREST_SIZES)
    pts = curve_points(hc, G1_GEN, sum(sizes), 5)
    rng = np.random.default_rng(9)
    sc = [int.from_bytes(rng.bytes(32), "little") % R for _ in pts]
    x = ints_to_limbs([p[0] for p in pts])
    y = ints_to_limbs([p[1] for p in pts])
    t0 = time.time()
    s_np = ints_to_limbs(sc)
    plan = msm_forest.host_plan(s_np, sizes)
    arr = msm_forest.dispatch_planned(x, y, plan, dev,
                                      msm_forest.ForestRecordings(1))
    totals = arr.cpu().numpy()
    got = msm.combine_window_totals_grouped(totals, len(sizes))
    dt = time.time() - t0
    want = [hc.g1_msm(sc[:sizes[0]], pts[:sizes[0]]),
            hc.g1_msm(sc[sizes[0]:], pts[sizes[0]:])]
    return ({"phase": "forest_msm", "points": len(pts), "groups": sizes,
             "equal_to_host_msm": got == want, "seconds": round(dt, 3)},
            (x, y, plan, dev, totals), (s_np, x, y, sizes, want))


def phase_scan_msm(torch, msm_scan, msm, weights, case, dev):
    """One scan MSM of a batch's size in each limb backend against the
    exact host MSM; the f8 window totals are the re-limbed u16 totals.
    Returns the phase line and the scan's device-stage inputs."""
    s_np, x, y, sizes, want = case
    t0 = time.time()
    idx, keys, levels = msm_scan.host_plan(s_np, sizes)
    plan_s = time.time() - t0
    totals, equal = {}, {}
    for backend in ("u16", "f8"):
        arr = msm_scan.msm_window_totals_grouped(
            x, y, idx, keys, len(sizes), levels, dev, backend=backend)
        totals[backend] = arr.cpu().numpy()
        equal[backend] = msm.combine_window_totals_grouped(
            totals[backend], len(sizes)) == want
    relimbed = bool((weights.limbs16_to_limbs8(totals["u16"])
                     == totals["f8"]).all())
    return ({"phase": "scan_msm", "points": int(s_np.shape[0]),
             "groups": sizes, "lanes": int(idx.shape[0]), "levels": levels,
             "bucket_grid": [len(sizes) * 32, 256],
             "host_plan_seconds": round(plan_s, 4),
             "equal_to_host_msm": equal,
             "f8_totals_equal_relimbed_u16_totals": relimbed},
            (x, y, idx, keys, len(sizes), levels, dev))


def tile(items, n):
    """n items cycling through `items` (bench.py's batches)."""
    return [items[i % len(items)] for i in range(n)]


def phase_stream(torch, kernels, fixture, BatchVerifier, n_batches, phase,
                 expect, batch_size=BATCH, decomp=True, **verifier_args):
    """One path through the entry point: a stream of n_batches batches of
    batch_size proofs (the fixture's items tiled; an item may carry its
    own vk) on a fresh verifier, every batch ok. The launch counts are set
    to 0 just before the stream and read just after it; every kernel named
    in `expect` must have launched, and no other kernel may have. The sqrt
    pre-pass must have run, or with decomp=False (the mesh's host
    decompression) must not have. Returns the phase line, the path's
    record (launches, lanes, widest launches, batches) and the warm
    verifier."""
    params, vk, items = fixture
    batch = tile(items, batch_size)
    bv = BatchVerifier(params, vk, **verifier_args)
    stamps = []
    kernels.reset_launches(record=True)
    t0 = time.time()
    for r in bv.verify_stream(batch for _ in range(n_batches)):
        stamps.append(time.time())
        if not r.ok:
            raise AssertionError(f"{phase}: batch {len(stamps)} failed")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    lanes = dict(kernels.LANES)
    widest = dict(kernels.WIDEST)
    if "host_assemble" not in bv.timings.totals:
        raise AssertionError("the VM fast path did not serve the stream")
    if decomp and bv.decomp_points_dispatched == 0:
        raise AssertionError("the sqrt pre-pass did not run")
    if not decomp and bv.decomp_points_dispatched != 0:
        raise AssertionError(f"{phase}: the sqrt pre-pass ran on a path "
                             "that keeps host decompression")
    for name, n in kernel_counts(kernels, launches).items():
        if name in expect and n == 0:
            raise AssertionError(f"{phase}: kernel {name} never launched")
        if name not in expect and n != 0:
            raise AssertionError(f"{phase}: kernel {name} launched {n} "
                                 "times on a path that does not hold it")
    steady = (len(stamps) - 1) * batch_size / (stamps[-1] - stamps[0])
    # a result is yielded two batches late, and the last two together when
    # the stream ends, so over a few batches the rate above reads high
    # (by 7/5 over 8 batches); the paced rate leaves those two out, and
    # the main thread's three timed stages are summed beside it
    paced = (len(stamps) - 3) * batch_size / (stamps[-3] - stamps[0])
    main_thread = sum(bv.timings.totals[k] for k in
                      ("host_replay", "host_assemble", "device_msm_dispatch"))
    result = {
        "phase": phase, "batches": n_batches, "batch_size": batch_size,
        **{k: str(v) for k, v in verifier_args.items() if k != "mesh"},
        "all_ok": True, "fast_path": "vm_raw",
        "proofs_per_s_steady": round(steady, 1),
        "rate_basis": "marginal over batches 2..k",
        "proofs_per_s_paced": round(paced, 1),
        "paced_basis": "marginal over batches 2..k-2",
        "main_thread_ms_per_batch": round(main_thread / n_batches * 1e3, 2),
        "first_batch_seconds": round(stamps[0] - t0, 3),
        "wall_seconds": round(stamps[-1] - t0, 3),
        "stages": bv.timings.report(),
        "point_adds_dispatched": bv.point_adds_dispatched,
        "msm_entries_dispatched": bv.msm_entries_dispatched,
        "decomp_points_dispatched": bv.decomp_points_dispatched,
        "point_adds_per_batch": bv.point_adds_dispatched / n_batches,
        "msm_entries_per_batch": bv.msm_entries_dispatched / n_batches,
        "launches": launches,
        "launches_per_batch": {k: round(v / n_batches, 2)
                               for k, v in launches.items() if v},
        "lanes": lanes,
    }
    if verifier_args.get("msm", "forest") == "forest" and "mesh" not in \
            verifier_args:
        result.update(forest_stream_record(bv, n_batches))
    record = {"launches": launches, "lanes": lanes, "widest": widest,
              "batches": n_batches}
    return result, record, bv


def dispatch_split(timings, n_batches):
    """device_msm_dispatch per batch (ms) split into its parts, and what
    the parts leave ("other": the orchestrator's own Python)."""
    per = {k[len("dispatch_"):]: timings.totals.get(k, 0.0) / n_batches * 1e3
           for k in DISPATCH_PARTS}
    total = timings.totals.get("device_msm_dispatch", 0.0) / n_batches * 1e3
    per["other"] = total - sum(per.values())
    return {"device_msm_dispatch_ms_per_batch": round(total, 4),
            "split_ms_per_batch": {k: round(v, 4) for k, v in per.items()}}


def forest_stream_record(bv, n_batches):
    """A single-device forest stream's dispatch split, and its
    recordings: made, replaced by a re-pin, replays, re-pins, and the
    live recordings' private memory pools."""
    recs = bv.forest_recordings
    return {**dispatch_split(bv.timings, n_batches),
            "recordings": recs.recorded,
            "recordings_replaced": recs.replaced,
            "recordings_evicted": recs.evicted,
            "replays": recs.replays, "plan_repins": bv.plan_repins,
            "recording_pool_bytes": recs.pool_bytes()}


def phase_tamper(torch, kernels, BatchVerifier, fixture, phase,
                 **verifier_args):
    """A TAMPER_BATCH-proof batch of the fixture's items (tiled), the one
    at TAMPER_INDEX with its first public input + 1 (and its own vk, if
    the items carry one), must fail at exactly that index."""
    from halo2_verifier_tpu_torch.ops.constants import R

    params, vk, items = fixture
    batch = tile(items, TAMPER_BATCH)
    p, inst, *own_vk = batch[TAMPER_INDEX]
    batch[TAMPER_INDEX] = (p, [[(inst[0][0] + 1) % R] + inst[0][1:]],
                           *own_vk)
    bv = BatchVerifier(params, vk, **verifier_args)
    kernels.reset_launches()
    (res,) = list(bv.verify_stream([batch]))
    torch.cuda.synchronize()
    if res.ok or res.failed_indices != [TAMPER_INDEX]:
        raise AssertionError(f"{phase}: ok={res.ok} "
                             f"failed={res.failed_indices}")
    line = {"phase": phase, "proofs": TAMPER_BATCH,
            "ok": res.ok, "failed_indices": res.failed_indices,
            "launches": dict(kernels.LAUNCHES)}
    if verifier_args.get("msm", "forest") == "forest" and "mesh" not in \
            verifier_args:
        recs = bv.forest_recordings
        line.update(pin_keys=sorted(bv._plan_pins),
                    recordings=recs.recorded,
                    recordings_replaced=recs.replaced,
                    recordings_evicted=recs.evicted, replays=recs.replays,
                    plan_repins=bv.plan_repins,
                    recording_pool_bytes=recs.pool_bytes())
    return line


def forest_chain_counts(kernels, msm_forest, layout):
    """({kernel: launches}, {kernel: lanes}) of one forest chain on the
    card, from its layout: the frontier, one point add per level and one
    for the deepest part (no add lanes), 7 folds and 14 Horner steps
    (L + 23 launches), the narrow ones among them in point_add_narrow."""
    tw = layout.tw
    adds = ([w for _oL, _oR, w in layout.levels] + [0]
            + [tw * msm_forest.WINDOW_BITS << k for k in range(7)]
            + [tw] * 14)
    narrow = [b for b in adds if b < kernels.narrow_below()]
    return ({"forest_frontier0": 1, "point_add": len(adds),
             "point_add_narrow": len(narrow)},
            {"forest_frontier0": layout.w0, "point_add": sum(adds),
             "point_add_narrow": sum(narrow)})


def phase_packed_parity(torch, np, hc, kernels, msm, msm_forest, case):
    """The forest dispatch's recordings at a main-path batch's size (phase
    4's points, groups of 1,024 and 15,616): a narrow batch (phase 4's
    scalars cut to 128 bits), then phase 4's batch (it outgrows the pin: a
    new recording replaces the first), another random batch, and phase
    4's batch again (a replay, its pin covering it). Each batch's points
    equal the host MSM's and its launches and lanes (counted through the
    replays) those its layout gives; the narrow batch's totals are
    bit-equal to the same chain's on the CPU (the plain versions, some
    tens of seconds at this size, so once); each recording's graph nodes
    are its package launches and the grid's one copy; the recordings'
    private pool and the time of each recording and replay."""
    from halo2_verifier_tpu_torch.ops.constants import R
    from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
    from halo2_verifier_tpu_torch.utils.metrics import StageTimings

    s_np, x, y, sizes, want_full = case
    narrow = s_np.copy()
    narrow[:, 8:] = 0
    rng = np.random.default_rng(17)
    other = ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % R
                           for _ in range(s_np.shape[0])])
    pts = list(zip(limbs_to_ints(x), limbs_to_ints(y)))
    dev = torch.device("cuda")
    recs = msm_forest.ForestRecordings()
    pin = None
    rows = []
    err = 0
    for name, sc in (("narrow", narrow), ("full", s_np), ("other", other),
                     ("full_again", s_np)):
        plan, pin = msm_forest.pin_plan_widths(
            msm_forest.host_plan(sc, sizes), pin)
        want = forest_chain_counts(kernels, msm_forest,
                                   msm_forest.packed_layout(plan))
        kernels.reset_launches()
        timings = StageTimings()
        t0 = time.perf_counter()
        got = msm_forest.dispatch_planned(
            x, y, plan, dev, recordings=recs, slot="parity",
            timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = ({k: v for k, v in kernels.LAUNCHES.items() if v},
                    {k: v for k, v in kernels.LANES.items()
                     if kernels.LAUNCHES[k]})
        same_launches = launched == want
        if name in ("full", "full_again"):
            host = want_full
        else:
            ss = limbs_to_ints(sc)
            host = [hc.g1_msm(ss[a:b], pts[a:b]) for a, b in
                    ((0, sizes[0]), (sizes[0], sum(sizes)))]
        equal_host = msm.combine_window_totals_grouped(
            got.cpu().numpy(), len(sizes)) == host
        equal_cpu = None
        if name == "narrow":
            cpu = msm_forest.dispatch_planned(x, y, plan, "cpu")
            equal_cpu = bool(torch.equal(got.cpu(), cpu))
            err = max(err, max_abs_err(torch, got.cpu(), cpu))
        nodes, tally = recs.counts("parity")
        no_glue = nodes == {"kernel": sum(
                                n for n, _ in kernel_counts(kernels,
                                                            tally).values()),
                            "memcpy": 1, "memset": 0, "other": 0}
        rows.append({
            "batch": name, "level_widths": [int(plan["point_idx0"].shape[0])]
            + [int(iL.shape[0]) for iL, _ in plan["levels"]],
            "equal_to_host_msm": equal_host,
            "totals_equal_cpu_chain": equal_cpu,
            "launches_equal_layout": same_launches,
            "graph_nodes": nodes, "graph_nodes_are_launches": no_glue,
            "launches": want[0],
            "recorded": "dispatch_record" in timings.totals,
            "ms": round(wall * 1e3, 3),
            "record_ms": round(timings.totals.get("dispatch_record", 0)
                               * 1e3, 3)})
        if not (equal_host and equal_cpu is not False and same_launches
                and no_glue):
            raise AssertionError(f"packed_parity: batch {name} differs: "
                                 f"{rows[-1]}")
    if recs.replays < 1 or recs.replaced < 1:
        raise AssertionError("packed_parity: no replay after a re-pin")
    return {"phase": "packed_parity", "tolerance": 0, "groups": list(sizes),
            "batches": rows, "recordings": recs.recorded,
            "recordings_replaced": recs.replaced, "replays": recs.replays,
            "recording_pool_bytes": recs.pool_bytes(),
            "max_abs_err": err}


def k9_workloads():
    """bench.py run_extras' two k=9 configurations at its sizes, with the
    keys derived by this package's prover from the tracked k=9 SRS and the
    proofs from the committed packs (load_pack checks each key's sha256
    against its pack's, so a keygen that differs from the reference's
    fails here): the mac_range circuit (k=9, 300 rows, 10 public inputs)
    and the vector_mul circuit (k=9, 4 products). Returns the setup line
    and {params, mac_vk, keccak_gwc, mac, mixed}: the 16 keccak256 x GWC
    proofs, the 8 blake2b x SHPLONK mac proofs, and K9_BATCH (proof,
    instances, vk) triples alternating mac (even index) and vector_mul
    (odd) proofs as bench.py builds them."""
    from halo2_verifier_tpu_torch.prover.circuits import (
        mac_range_spec, vector_mul_spec)
    from halo2_verifier_tpu_torch.prover.fixtures import load_pack
    from halo2_verifier_tpu_torch.prover.keygen import keygen
    from halo2_verifier_tpu_torch.prover.srs import load_srs

    t0 = time.perf_counter()
    srs = load_srs(9)
    t_srs = time.perf_counter() - t0
    mac_spec, mac_mk = mac_range_spec(9, 300, 10)
    mac_pk = keygen(mac_spec, srs)
    vm_spec, vm_mk_raw = vector_mul_spec(9, 4)
    vm_pk = keygen(vm_spec, srs)

    def vm_mk(s):
        return vm_mk_raw([int(s) + 2] * 4, [int(s) + 5] * 4)

    keccak_gwc = load_pack("bench_mac_k9_keccak_gwc_pack", mac_pk, mac_mk,
                           list(range(16)), hash_name="keccak256",
                           multiopen="gwc")
    mac = load_pack("bench_mac_k9_pack", mac_pk, mac_mk, list(range(8)))
    vm = load_pack("bench_vm_k9_pack", vm_pk, vm_mk, list(range(8)))
    mixed = [(*mac[(i // 2) % len(mac)], mac_pk.vk) if i % 2 == 0
             else (*vm[(i // 2) % len(vm)], vm_pk.vk)
             for i in range(K9_BATCH)]
    line = {"phase": "k9_setup", "load_srs_seconds": round(t_srs, 3),
            "seconds": round(time.perf_counter() - t0, 3),
            "packs": {"bench_mac_k9_keccak_gwc_pack": len(keccak_gwc),
                      "bench_mac_k9_pack": len(mac),
                      "bench_vm_k9_pack": len(vm)},
            "vk_sha256_equal_to_packs": True}
    return line, {"params": srs.verifier_params(), "mac_vk": mac_pk.vk,
                  "keccak_gwc": keccak_gwc, "mac": mac, "mixed": mixed}


def phase_cli(torch, kernels, k9):
    """The verify command, through the port's CLI: the 164-byte params
    from convert-params on the tracked k=9 SRS, the mac vk, one keccak256
    x GWC proof of the pack and its instances written to a temporary
    directory; cli.main(verify --multiopen gwc --hash keccak256) in this
    process must print OK and return 0 with the forest kernels launched
    (counts set to 0 just before, read just after) and no other; a
    blake2b x SHPLONK proof with the defaults likewise; then the probes,
    each FAIL and 1: the instances with one value + 1, --hash keccak256
    on the blake2b proof, --multiopen gwc on the SHPLONK proof, and the
    keccak256 proof cut to half its length. Last, the same OK verify as a
    subprocess, `python -m halo2_verifier_tpu_torch.cli verify ...` on the
    card, must exit 0."""
    import contextlib
    import io
    import tempfile

    from halo2_verifier_tpu_torch import cli

    def run_cli(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        return rc, buf.getvalue().strip(), round(time.perf_counter() - t0, 3)

    def instances_text(inst, bump=0):
        col = [inst[0][0] + bump] + list(inst[0][1:])
        return "\n".join(str(v) for v in col) + "\n"

    res = {"phase": "cli_path"}
    with tempfile.TemporaryDirectory(prefix="h2v_cli_") as d:
        def put(name, data):
            path = os.path.join(d, name)
            with open(path, "wb" if isinstance(data, bytes) else "w") as f:
                f.write(data)
            return path

        params = os.path.join(d, "params.bin")
        rc, text, _ = run_cli(["convert-params",
                               os.path.join(HERE, "params", "kzg_bn254_9.srs"),
                               params])
        if rc != 0 or os.path.getsize(params) != 164:
            raise AssertionError(f"cli_path: convert-params rc={rc}: {text}")
        res["params_bytes"] = os.path.getsize(params)
        vk = put("vk.bin", k9["mac_vk"].to_bytes())
        kg_proof, kg_inst = k9["keccak_gwc"][0]
        bs_proof, bs_inst = k9["mac"][0]
        kg = put("proof_keccak_gwc.bin", kg_proof)
        kg_txt = put("instances_keccak_gwc.txt", instances_text(kg_inst))
        bs = put("proof_blake2b_shplonk.bin", bs_proof)
        bs_txt = put("instances_blake2b_shplonk.txt", instances_text(bs_inst))
        gwc = ["--multiopen", "gwc", "--hash", "keccak256"]
        ok_argv = ["verify", params, vk, kg, "--instances", kg_txt, *gwc]

        kernels.reset_launches()
        rc, text, secs = run_cli(ok_argv)
        launches = dict(kernels.LAUNCHES)
        if (rc, text) != (0, "OK"):
            raise AssertionError(f"cli_path: verify gave {text!r}, rc={rc}")
        for name, n in kernel_counts(kernels, launches).items():
            if (name in FOREST_KERNELS) != (n > 0):
                raise AssertionError(f"cli_path: kernel {name} launched {n} "
                                     "times")
        res["verify_keccak_gwc"] = {"stdout": text, "rc": rc,
                                    "seconds": secs,
                                    "launches": {k: v for k, v in
                                                 launches.items() if v}}
        rc, text, secs = run_cli(["verify", params, vk, bs,
                                  "--instances", bs_txt])
        if (rc, text) != (0, "OK"):
            raise AssertionError(f"cli_path: blake2b x SHPLONK verify gave "
                                 f"{text!r}, rc={rc}")
        res["verify_blake2b_shplonk"] = {"stdout": text, "rc": rc,
                                         "seconds": secs}
        probes = {
            "tampered_instances": [kg, "--instances", put(
                "instances_bad.txt", instances_text(kg_inst, 1)), *gwc],
            "keccak256_on_blake2b_proof": [bs, "--instances", bs_txt,
                                           "--hash", "keccak256"],
            "gwc_on_shplonk_proof": [bs, "--instances", bs_txt,
                                     "--multiopen", "gwc"],
            "truncated_proof": [put("proof_truncated.bin",
                                    kg_proof[:len(kg_proof) // 2]),
                                "--instances", kg_txt, *gwc],
        }
        res["probes"] = {}
        for name, args in probes.items():
            rc, text, secs = run_cli(["verify", params, vk, *args])
            if (rc, text) != (1, "FAIL"):
                raise AssertionError(f"cli_path: probe {name} gave {text!r}, "
                                     f"rc={rc}")
            res["probes"][name] = {"stdout": text, "rc": rc,
                                   "seconds": secs}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "halo2_verifier_tpu_torch.cli", *ok_argv],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or proc.stdout.strip() != "OK":
            raise AssertionError(
                f"cli_path: subprocess exit {proc.returncode}, stdout "
                f"{proc.stdout.strip()!r}, stderr {proc.stderr[-2000:]!r}")
        res["subprocess"] = {"argv": ["-m", "halo2_verifier_tpu_torch.cli",
                                      "verify", "...", *gwc],
                             "stdout": proc.stdout.strip(),
                             "rc": proc.returncode,
                             "seconds": round(time.perf_counter() - t0, 3)}
    return res


def phase_double_path(torch, np, hc, fm, curve, kernels, ints_to_limbs, dev):
    """The doubling's path: its public entry, ops/curve.double, at the
    parity width (neither package's verifier doubles on the device; the
    reference's kernel is reached through lmcurve.double alone). Counts
    are set to 0 just before and read just after."""
    f, _iL, _iR, _mask, pool = add_case(torch, np, hc, fm, curve,
                                        ints_to_limbs, dev,
                                        POINT_DOUBLE_WIDTH)
    kernels.reset_launches(record=True)
    out = curve.double(curve.double(f))
    torch.cuda.synchronize()
    record = {"launches": dict(kernels.LAUNCHES),
              "lanes": dict(kernels.LANES), "widest": dict(kernels.WIDEST),
              "batches": 1}
    n = len(pool)
    quad = curve.to_affine_host(tuple(c[:, :n] for c in out))
    ok = quad == [hc.g1_double(hc.g1_double(q)) for q in pool]
    if not ok or record["launches"]["point_double"] != 2:
        raise AssertionError("double_path: 4P differs from the host curve's")
    return ({"phase": "double_path", "entry": "ops/curve.double",
             "lanes": POINT_DOUBLE_WIDTH, "equal_to_host_curve": ok,
             "launches": record["launches"]}, record)


def timed_once(torch, fn):
    """(fn(), its CUDA-event milliseconds), one call, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    stop.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(stop)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def phase_minor_path(torch, np, hc, fm, fmin, cmin, curve, kernels,
                     ints_to_limbs, limbs_to_ints, dev):
    """The limb-minor layer (ops/field_minor.py, ops/curve_minor.py) on
    (..., 16) limbs at main-path widths: mont_mul, add and sub on Fq and
    Fr at MINOR_FIELD_SHAPE, curve_minor.add at MINOR_ADD_WIDTH (the point
    add's cases: P+P, P+(-P), identities), double at POINT_DOUBLE_WIDTH
    (the add's outputs: general Z), inv_mont and to_affine_batch (the
    add's outputs) at MINOR_INV_WIDTH, pow_fixed with (P+1)/4 at
    MINOR_POW_WIDTH. Counts are set to 0 just before and read just after;
    each call's own launches are held to one K1 per mont_mul, one K2 per
    add, one K3 per double, T3 per inv_mont, T3 and two K1 per
    to_affine_batch, K1 per product of pow_fixed, none for add and sub.
    Then each result is held against its plain version on the card
    (plain=True; add and sub are plain torch themselves), against the
    limbs-major route on the transposed inputs (the kernels, or
    ops/field.py's bodies for add and sub; bit-equal), and on
    MINOR_SAMPLE lanes against the host oracle; each function is timed
    whole, and its transposes apart from its kernels. Returns the line
    and the path's record."""
    from halo2_verifier_tpu_torch.ops.constants import FOLD_EDGE, P

    rng = np.random.default_rng(17)

    def minor(limbs, shape):
        return torch.from_numpy(limbs.astype(np.int32)).to(dev).reshape(
            *shape, 16)

    field_in = {}
    n_field = MINOR_FIELD_SHAPE[0] * MINOR_FIELD_SHAPE[1]
    for spec in (fm.FQ, fm.FR):
        a = random_field(np, rng, spec.modulus, n_field)
        b = random_field(np, rng, spec.modulus, n_field)
        edge = ints_to_limbs([0, 1, spec.modulus - 1, spec.modulus - 2])
        a[:4], b[4:8] = edge, edge
        if spec is fm.FQ:
            a[-3:] = ints_to_limbs([x for x, _ in FOLD_EDGE])
            b[-3:] = ints_to_limbs([y for _, y in FOLD_EDGE])
        field_in[spec] = (minor(a, MINOR_FIELD_SHAPE),
                          minor(b, MINOR_FIELD_SHAPE))
    f, iL, iR, _mask, pool = add_case(torch, np, hc, fm, curve,
                                      ints_to_limbs, dev, MINOR_ADD_WIDTH)
    p_in = tuple(c[:, iL.long()].t().contiguous() for c in f)
    q_in = tuple(c[:, iR.long()].t().contiguous() for c in f)
    inv_in = minor(random_field(np, rng, P, MINOR_INV_WIDTH),
                   (MINOR_INV_WIDTH,))
    inv_in[0] = 0
    pow_in = minor(random_field(np, rng, P, MINOR_POW_WIDTH),
                   (MINOR_POW_WIDTH,))
    sqrt_exp = (P + 1) // 4
    pow_bits = [(sqrt_exp >> i) & 1 for i in range(sqrt_exp.bit_length())]

    # name -> (card function, plain version or None, limbs-major route on
    # the transposed inputs, arguments, the call's expected launches)
    cases = {}
    for spec, tag in ((fm.FQ, "fq"), (fm.FR, "fr")):
        k1 = {"mont_mul": 1}
        cases[f"mont_mul_{tag}"] = (
            lambda a, b, s=spec: fmin.mont_mul(a, b, s),
            lambda a, b, s=spec: fmin.mont_mul(a, b, s, plain=True),
            lambda x, y, s=spec: kernels.mont_mul(x, y, s.kernel_id),
            field_in[spec], k1)
        for op in ("add", "sub"):
            cases[f"{op}_{tag}"] = (
                lambda a, b, s=spec, op=op: getattr(fmin, op)(a, b, s),
                None, lambda x, y, s=spec, op=op: getattr(fm, op)(x, y, s),
                field_in[spec], {})
    cases["curve_add"] = (
        lambda *cs: cmin.add(cs[:3], cs[3:]),
        lambda *cs: cmin.add(cs[:3], cs[3:], plain=True),
        lambda *cs: kernels.point_add(cs[:3], cs[3:]),
        p_in + q_in, {"point_add": 1})
    outs, by_call = {}, {}

    def drive(name):
        fn, _plain, _major, args, expect = cases[name]
        before = dict(kernels.LAUNCHES)
        outs[name] = as_tuple(fn(*args))
        by_call[name] = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                         if v != before[k]}
        if by_call[name] != expect:
            raise AssertionError(f"minor_path: {name} launched "
                                 f"{by_call[name]}, expected {expect}")

    def affine_major(X, Y, Z):
        zinv = kernels.fq_inv(Z, fm.FQ.kernel_id)
        inf = (Z == 0).all(dim=0)
        return tuple(torch.where(inf, 0, kernels.mont_mul(
            c, zinv, fm.FQ.kernel_id)) for c in (X, Y))

    kernels.reset_launches()
    for name in list(cases):
        drive(name)
    added = outs["curve_add"]  # general Z: the doubling's and the map's
    cases["curve_double"] = (
        lambda *cs: cmin.double(cs),
        lambda *cs: cmin.double(cs, plain=True),
        lambda *cs: kernels.point_double(cs),
        tuple(torch.cat([c, c])[:POINT_DOUBLE_WIDTH] for c in added),
        {"point_double": 1})
    cases["to_affine_batch"] = (
        lambda *cs: cmin.to_affine_batch(cs),
        lambda *cs: cmin.to_affine_batch(cs, plain=True), affine_major,
        tuple(c[:MINOR_INV_WIDTH] for c in added),
        {"fq_inv": 1, "mont_mul": 2})
    cases["inv_mont"] = (
        lambda a: fmin.inv_mont(a, fm.FQ),
        lambda a: fmin.inv_mont(a, fm.FQ, plain=True),
        lambda x: kernels.fq_inv(x, fm.FQ.kernel_id), (inv_in,),
        {"fq_inv": 1})
    cases["pow_fixed"] = (
        lambda a: fmin.pow_fixed(a, sqrt_exp, fm.FQ),
        lambda a: fmin.pow_fixed(a, sqrt_exp, fm.FQ, plain=True),
        lambda x: fm.pow_bits_body(
            x, pow_bits, fm.FQ,
            mul=lambda u, v: kernels.mont_mul(u, v, fm.FQ.kernel_id)),
        (pow_in,), {"mont_mul": sum(pow_bits) + len(pow_bits) - 1})
    for name in ("curve_double", "to_affine_batch", "inv_mont", "pow_fixed"):
        drive(name)
    torch.cuda.synchronize()
    record = {"launches": dict(kernels.LAUNCHES)}

    # the host oracle on MINOR_SAMPLE lanes of each output
    lanes = {}
    for name, (_fn, _p, _m, args, _e) in cases.items():
        n = args[0].numel() // 16
        pick = rng.choice(n - 8, MINOR_SAMPLE - 8, replace=False) + 8
        lanes[name] = np.concatenate([np.arange(8), np.sort(pick)])

    def ints(t, name):
        return limbs_to_ints(t.reshape(-1, 16)[
            torch.from_numpy(lanes[name]).to(t.device)].cpu().numpy())

    rinv = pow(fm.FQ.mont_r, -1, P)
    n_pool = len(pool)
    iL_h, iR_h = iL.tolist(), iR.tolist()

    def host_added(i):
        return hc.g1_add(pool[iL_h[i] % n_pool], pool[iR_h[i] % n_pool])

    def affine(name, pt):
        """The sampled lanes of projective points as host points."""
        major = tuple(c.reshape(-1, 16)[torch.from_numpy(lanes[name]).to(
            c.device)].t().contiguous() for c in pt)
        return curve.to_affine_host(major)

    host_ok = {}
    for spec, tag in ((fm.FQ, "fq"), (fm.FR, "fr")):
        N = spec.modulus
        srinv = pow(spec.mont_r, -1, N)
        for op, want in (("mont_mul", lambda x, y: x * y * srinv % N),
                         ("add", lambda x, y: (x + y) % N),
                         ("sub", lambda x, y: (x - y) % N)):
            name = f"{op}_{tag}"
            a, b = (ints(t, name) for t in cases[name][3])
            host_ok[name] = ints(outs[name][0], name) == [
                want(x, y) for x, y in zip(a, b)]
    host_ok["curve_add"] = affine("curve_add", outs["curve_add"]) == [
        host_added(int(i)) for i in lanes["curve_add"]]
    host_ok["curve_double"] = affine(
        "curve_double", outs["curve_double"]) == [
        hc.g1_double(host_added(int(i) % MINOR_ADD_WIDTH))
        for i in lanes["curve_double"]]
    xs, ys = (ints(c, "to_affine_batch") for c in outs["to_affine_batch"])
    host_ok["to_affine_batch"] = [
        None if (x, y) == (0, 0) else (x * rinv % P, y * rinv % P)
        for x, y in zip(xs, ys)] == [host_added(int(i))
                                     for i in lanes["to_affine_batch"]]
    a, got = ints(inv_in, "inv_mont"), ints(outs["inv_mont"][0], "inv_mont")
    host_ok["inv_mont"] = got == [
        0 if x == 0 else pow(x * rinv, -1, P) * fm.FQ.mont_r % P for x in a]
    a, got = ints(pow_in, "pow_fixed"), ints(outs["pow_fixed"][0],
                                             "pow_fixed")
    host_ok["pow_fixed"] = got == [
        pow(x * rinv, sqrt_exp, P) * fm.FQ.mont_r % P for x in a]

    funcs, worst = {}, 0
    for name, (fn, plain, major, args, _e) in cases.items():
        shape, xs = fmin.to_major(*args)
        major_out = as_tuple(major(*xs))
        equal_major = all(torch.equal(fmin.to_minor(c, shape), o)
                          for c, o in zip(major_out, outs[name]))
        row = {"shape": list(args[0].shape), "lanes": args[0].numel() // 16,
               "launches": by_call[name], "equal_limbs_major": equal_major,
               "host_sample_equal": host_ok[name]}
        if plain is not None:
            want, row["plain_ms"] = timed_once(torch, lambda: plain(*args))
            row["max_abs_err"] = max_abs_err(torch, outs[name],
                                             as_tuple(want))
            worst = max(worst, row["max_abs_err"])
        reps = 3 if name in ("inv_mont", "to_affine_batch",
                             "pow_fixed") else 10
        row["ms"] = time_ms(torch, lambda: fn(*args), reps)
        if by_call[name]:  # the adapter's transposes around the kernels
            row["to_major_ms"] = time_ms(torch,
                                         lambda: fmin.to_major(*args), reps)
            row["kernel_ms"] = time_ms(torch, lambda: major(*xs), reps)
            row["to_minor_ms"] = time_ms(torch, lambda: [
                fmin.to_minor(c, shape) for c in major_out], reps)
        funcs[name] = {k: round(v, 4) if isinstance(v, float) else v
                       for k, v in row.items()}
        if not (equal_major and host_ok[name]):
            raise AssertionError(f"minor_path: {name} differs from the "
                                 "limbs-major route or the host oracle")
    return ({"phase": "minor_path",
             "entry": "ops/field_minor.py, ops/curve_minor.py",
             "tolerance": 0, "max_abs_err": worst,
             "host_sample_lanes": MINOR_SAMPLE,
             "launches": {k: v for k, v in record["launches"].items() if v},
             "functions": funcs}, record)


def tower_operands(np, rng, modulus, ints_to_limbs, width):
    """(a, b): (16, width) uint32 limbs of canonical values, the edge
    values (0, 1, p - 1, runs of one-words, the FOLD_EDGE pairs against
    each other) in the first lanes, random ones after."""
    from halo2_verifier_tpu_torch.ops.constants import FOLD_EDGE, FQ_EDGE

    edge_a = [v % modulus for v in FQ_EDGE + [x for x, _ in FOLD_EDGE]]
    edge_b = [v % modulus for v in FQ_EDGE[::-1] + [y for _, y in FOLD_EDGE]]
    a = random_field(np, rng, modulus, width)
    b = random_field(np, rng, modulus, width)
    n = min(width, len(edge_a))
    a[:n] = ints_to_limbs(edge_a[:n])
    b[:n] = ints_to_limbs(edge_b[:n])
    return a.T.copy(), b.T.copy()


def fq12_stacks(np, rng, ints_to_limbs, width):
    """(a, b): (16, 12, width) int32 coefficient stacks, the edge pairs
    (constants.fq12_edge_pairs: zero coefficients, the FOLD_EDGE pairs in
    one product, every FQ_EDGE value in every coefficient) in the first
    lanes, random canonical values after."""
    from halo2_verifier_tpu_torch.ops.constants import P, fq12_edge_pairs

    pairs = fq12_edge_pairs()[:width]
    out = []
    for side in (0, 1):
        limbs = random_field(np, rng, P, 12 * width).reshape(12, width, 16)
        for lane, pair in enumerate(pairs):
            limbs[:, lane] = ints_to_limbs(list(pair[side]))
        out.append(np.ascontiguousarray(limbs.transpose(2, 0, 1))
                   .astype(np.int32))
    return out


def step_operands(torch, np, rng, ints_to_limbs, width, dev):
    """(T, Q, P2): Miller step operands of `width` lanes, the edge lanes
    (constants.miller_step_edge_lanes: a zero denominator in each mode,
    every FQ_EDGE value in every coordinate) first, random canonical
    values after; T and Q (16, 4, width) stacks, P2 the (2, 16, width)
    rows px, py as pairing_product holds them."""
    from halo2_verifier_tpu_torch.ops.constants import (
        P, miller_step_edge_lanes)

    lanes = miller_step_edge_lanes()[:width]
    n = len(lanes)
    limbs = random_field(np, rng, P, 10 * width).reshape(10, width, 16)
    for c in range(10):
        limbs[c, :n] = ints_to_limbs([lane[c] for lane in lanes])
    x = torch.from_numpy(np.ascontiguousarray(
        limbs.transpose(0, 2, 1)).astype(np.int32)).to(dev)
    return (x[0:4].transpose(0, 1).contiguous(),
            x[4:8].transpose(0, 1).contiguous(), x[8:10].contiguous())


def phase_tower(torch, np, card, fm, tp, kernels, ints_to_limbs, dev):
    """The device pairing's tower kernels against their plain versions,
    bit for bit, at the pairing's widths (1 and 2 lanes: two live pairs)
    and at 16,384 lanes: T1 add, sub and neg (operand a a column slice of
    a wider tensor, read at its own row stride), the fused Fq12 multiply and square on the edge pairs, T3 for Fq
    and Fr (0 -> 0 in the first lane), the Miller step in both modes on
    its edge lanes (px and py column slices of a wider tensor). Each
    kernel also timed at 16,384 lanes beside its plain version and its
    bound (T3 for Fq and Fr, the step in both modes)."""
    rng = np.random.default_rng(12)
    checked, worst, wide = [], 0, {}

    def up(x):
        return torch.from_numpy(x.astype(np.int32)).to(dev)

    a_np, b_np = tower_operands(np, rng, fm.FQ.modulus, ints_to_limbs,
                                max(TOWER_WIDTHS))
    A2 = up(np.concatenate([a_np, b_np], axis=1))
    for w in TOWER_WIDTHS:
        a, b = A2[:, :w], up(b_np[:, :w])
        for op in (kernels.FQ_ADD, kernels.FQ_SUB, kernels.FQ_NEG):
            args = (a, None if op == kernels.FQ_NEG else b, op)
            plain, _, _ = kernel_case("fq_addsub", args, None, fm, None,
                                      None)
            err = max_abs_err(torch, kernels.fq_addsub(*args), plain())
            worst = max(worst, err)
            checked.append(["fq_addsub", op, w, err])
    wide["fq_addsub"] = (A2[:, :max(TOWER_WIDTHS)],
                         up(b_np), kernels.FQ_ADD)
    stacks = fq12_stacks(np, rng, ints_to_limbs, max(TOWER_WIDTHS))
    A, B = (up(x) for x in stacks)
    for w in TOWER_WIDTHS:
        a, b = A[:, :, :w].contiguous(), B[:, :, :w].contiguous()
        for name, args in (("fq12_mul", (a, b)), ("fq12_square", (a, a))):
            err = max_abs_err(torch, tp.fq12_mul_stack(*args),
                              tp.fq12_mul_plain(*args))
            worst = max(worst, err)
            checked.append([name, w, err])
    wide["fq12_mul"] = (A, B)
    for spec in (fm.FQ, fm.FR):
        x = up(tower_operands(np, rng, spec.modulus, ints_to_limbs,
                              max(TOWER_WIDTHS))[0])
        for w in TOWER_WIDTHS:
            args = (x[:, :w].contiguous(), spec.kernel_id)
            plain, _, _ = kernel_case("fq_inv", args, None, fm, None, None)
            got = fm.inv_mont(args[0], spec)  # the entry that dispatches
            err = max(max_abs_err(torch, got, plain()),
                      int(got[:, 0].abs().max()))  # inv(0) = 0
            worst = max(worst, err)
            checked.append(["fq_inv", spec.kernel_id, w, err])
        wide["fq_inv" if spec is fm.FQ else "fq_inv_fr"] = args
    T, Q, P2 = step_operands(torch, np, rng, ints_to_limbs,
                             max(TOWER_WIDTHS), dev)
    for w in TOWER_WIDTHS:
        t, q = T[:, :, :w].contiguous(), Q[:, :, :w].contiguous()
        p = (P2[0, :, :w], P2[1, :, :w])  # rows at the wider stride
        for mode in (kernels.MILLER_DOUBLE, kernels.MILLER_ADD):
            qm = q if mode == kernels.MILLER_ADD else None
            err = max_abs_err(torch, tp._miller_step(mode, t, qm, p),
                              tp.miller_step_plain(mode, t, qm, p))
            worst = max(worst, err)
            checked.append(["miller_step", mode, w, err])
    wide["miller_step"] = (kernels.MILLER_DOUBLE, T, None, P2[0], P2[1])
    wide["miller_step_add"] = (kernels.MILLER_ADD, T, Q, P2[0], P2[1])
    timings = {}
    for label, args in wide.items():
        name = label.removesuffix("_fr").removesuffix("_add")
        fn = getattr(kernels, name)
        plain, nbytes, counts = kernel_case(name, args, None, fm, None, None)
        bound_ms, bound_by = card.bound(nbytes, counts)
        ms, ms_basis, events_ms = kernel_ms(torch, name, lambda: fn(*args))
        timings[label] = {
            "lanes": int(args[1 if name == "miller_step" else 0].shape[-1]),
            "ms": sig(ms),
            "ms_basis": ms_basis, "events_ms": round(events_ms, 4),
            "plain_ms": round(time_ms(torch, plain, reps=1), 4),
            "bound_ms": sig(bound_ms), "bound_by": bound_by,
            "share": round(bound_ms / ms, 4), "bytes": nbytes,
            "operations_by_pipe": dict(zip(("imad", "alu", "fp32"), counts))}
    return {"phase": "parity_tower", "tolerance": 0, "widths":
            list(TOWER_WIDTHS), "max_abs_err": worst, "checked": checked,
            "timing_16384_lanes": timings}


def pairing_lanes(torch, np, tp, pairs, dev):
    g1 = np.stack([tp.mont_cols([p[i] for p, _ in pairs]) for i in (0, 1)])
    g2 = np.stack([tp.mont_cols([q[i][j] for _, q in pairs])
                   for i in (0, 1) for j in (0, 1)])
    return torch.from_numpy(g1).to(dev), torch.from_numpy(g2).to(dev)


def phase_pairing(torch, np, card, tp, hp, hc, kernels, dev):
    """The device pairing check on the card: the Miller lanes of three
    pairs equal the host oracle's (hostpairing.miller_loop), the
    bilinearity verdicts (good and tampered) the host pairing's; the time
    of one check (median of PAIRING_REPS) beside the host pairing's on
    the same pairs; launches per check by kernel, which must be the
    dispatch's counts (PAIRING_LAUNCHES: the Fq12 multiply fused, one
    Miller step kernel per step);
    the profiler's count of device kernels and copies in one check and
    their device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from halo2_verifier_tpu_torch.ops.constants import G1_GEN, G2_GEN

    def g1(k):
        return hc.g1_mul(G1_GEN, k)

    def g2(k):
        return hc.g2_mul(G2_GEN, k)

    pairs = [(g1(3), g2(5)), (g1(7), g2(11)), (g1(1), g2(1))]
    lanes = tp.miller_lanes(*pairing_lanes(torch, np, tp, pairs, dev))
    if any(tp.fq12_from_device(lanes, lane=i) != hp.miller_loop(p, q)
           for i, (p, q) in enumerate(pairs)):
        raise AssertionError("pairing: Miller lanes differ from the host's")
    good = [(g1(6), g2(13)), (hc.g1_neg(g1(78)), G2_GEN)]
    bad = [good[0], (hc.g1_neg(g1(79)), G2_GEN)]
    verdicts = {name: (tp.pairing_check_device(pairs_, dev),
                       hp.pairing_check(pairs_))
                for name, pairs_ in (("good", good), ("bad", bad))}
    if verdicts != {"good": (True, True), "bad": (False, False)}:
        raise AssertionError(f"pairing: verdicts {verdicts}")

    def median_s(fn):
        times = []
        for _ in range(PAIRING_REPS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2], times

    dev_s, dev_all = median_s(lambda: tp.pairing_check_device(good, dev))
    host_s, host_all = median_s(lambda: hp.pairing_check(good))
    kernels.reset_launches()
    tp.pairing_check_device(good, dev)
    launches = {k: kernels.LAUNCHES[k] for k in PAIRING_LAUNCHES}
    if launches != PAIRING_LAUNCHES or sum(kernels.LAUNCHES.values()) != sum(
            PAIRING_LAUNCHES.values()):
        raise AssertionError(f"pairing: launches per check "
                             f"{dict(kernels.LAUNCHES)}, the dispatch counts "
                             f"{PAIRING_LAUNCHES}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tp.pairing_check_device(good, dev)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    by_name = collections.Counter(e.name[:60] for e in events)
    busy = device_times(prof)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    # device time per launch of the package's kernels in this check (CUDA
    # events around back-to-back launches this small time the host's
    # dispatch, not the kernel)
    per_launch = {}
    for name, kernel in (("mont_mul", "mont_mul_kernel<0>"),
                         ("fq_addsub", "fq_addsub_kernel"),
                         ("fq12_mul", "fq12_mul_kernel"),
                         ("fq_inv", "fq_inv_kernel<0,"),
                         ("miller_step", "miller_step_kernel")):
        ev = [e for e in events if kernel in e.name]
        if ev:
            per_launch[name] = round(
                sum(e.time_range.elapsed_us() for e in ev) / len(ev), 3)
    return {"phase": "pairing", "miller_lanes_equal_host": True,
            "verdicts_device_host": verdicts, "live_pairs": len(good),
            "check_ms_median": round(dev_s * 1e3, 3),
            "check_ms_all": [round(t * 1e3, 3) for t in dev_all],
            "host_pairing_ms_median": round(host_s * 1e3, 3),
            "host_pairing_ms_all": [round(t * 1e3, 3) for t in host_all],
            "device_over_host": round(dev_s / host_s, 2),
            "launches_per_check": launches,
            "package_kernel_launches_per_check": sum(launches.values()),
            "profiler_device_kernels_per_check": len(events) - len(copies),
            "profiler_device_copies_per_check": len(copies),
            "profiler_kernels_per_check_by_name": dict(
                by_name.most_common(10)),
            "profiler_device_busy_ms_per_check":
                round(sum(busy.values()) / 1e3, 3) if busy else None,
            "profiler_device_us_per_launch": per_launch,
            "device_ms_by_name": {k[:60]: round(v / 1e3, 3)
                                  for k, v in top}}


def phase_single(torch, kernels, BatchVerifier, fixture):
    """strategy="single" with the device pairing: one check per proof on
    SINGLE_PROOFS proofs, one with a public input + 1, which must fail at
    its index; the counts are set to 0 just before and read just after,
    and only K1, T1, the fused Fq12 multiply, T3 and the Miller step may
    launch (the single strategy's MSMs run on the host, as in the
    reference's SingleStrategy). The host pairing's verdict and time on
    the same batch beside it."""
    from halo2_verifier_tpu_torch.ops.constants import R

    params, vk, items = fixture
    batch = list(items[:SINGLE_PROOFS])
    p, inst = batch[SINGLE_TAMPER_INDEX]
    batch[SINGLE_TAMPER_INDEX] = (p, [[(inst[0][0] + 1) % R] + inst[0][1:]])
    expect = ("mont_mul", "fq_addsub", "fq12_mul", "fq_inv", "miller_step")
    out_ = {"phase": "single_device_pairing", "proofs": SINGLE_PROOFS}
    for pairing in ("device", "host"):
        bv = BatchVerifier(params, vk, strategy="single", pairing=pairing)
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = bv.verify(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if res.ok or res.failed_indices != [SINGLE_TAMPER_INDEX]:
            raise AssertionError(f"single_device_pairing ({pairing}): "
                                 f"ok={res.ok} failed={res.failed_indices}")
        for name, n in kernel_counts(kernels, launches).items():
            want = pairing == "device" and name in expect
            if want != (n > 0):
                raise AssertionError(f"single_device_pairing ({pairing}): "
                                     f"kernel {name} launched {n} times")
        out_[pairing] = {"failed_indices": res.failed_indices,
                         "seconds": round(dt, 3),
                         "launches": {k: v for k, v in launches.items()
                                      if v}}
    return out_


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh_path(torch, np, kernels, msm_forest, fixture, BatchVerifier,
                    forest_inputs, case):
    """The mesh on one NCCL rank in this process (a process group of one):
    phase 4's batch-sized MSM in the window-sharded and the point-sharded
    forest (its bucket grid through all_to_all_single on NCCL), each
    kind's totals bit-equal to the single-device forest's and its points
    to the host MSM's; then BatchVerifier(mesh=...) over MESH_BATCHES
    streamed batches (counts set to 0 just before, read just after; the
    frontier and point-add kernels alone, host decompression) and the
    tampered batch. Returns the line and the stream's record."""
    from halo2_verifier_tpu_torch.parallel import dist, mesh as pmesh

    single = forest_inputs[-1]
    s_np, x, y, sizes, want = case
    if not dist.init_distributed(coordinator=f"127.0.0.1:{free_port()}",
                                 num_processes=1, process_id=0,
                                 backend="nccl", timeout=300):
        raise AssertionError("mesh_path: no process group formed")
    try:
        mesh = pmesh.make_mesh(1)
        if (mesh.backend, mesh.size, mesh.group is None) != ("nccl", 1,
                                                            False):
            raise AssertionError(f"mesh_path: mesh {mesh}")
        kinds = {}
        for kind, fn, combine in (
                ("windows", pmesh.sharded_forest_by_windows,
                 pmesh.combine_sharded_windows),
                ("forest", pmesh.sharded_forest_window_totals,
                 pmesh.combine_sharded_forest)):
            stats = {}
            kernels.reset_launches()
            t0 = time.perf_counter()
            arr = fn(mesh, x, y, s_np, sizes, stats=stats)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = arr.cpu().numpy()
            kinds[kind] = {
                "seconds": round(dt, 4), "wire": stats,
                "totals_equal_single_device": bool(
                    (pmesh.windows_in_order(got, len(sizes)) == single).all()),
                "equal_to_host_msm": combine(got, len(sizes)) == want,
                "launches": {k: v for k, v in kernels.LAUNCHES.items()
                             if v}}
            if not (kinds[kind]["totals_equal_single_device"]
                    and kinds[kind]["equal_to_host_msm"]):
                raise AssertionError(f"mesh_path: the {kind} kind differs "
                                     "from the single-device forest")
            if set(kernel_counts(kernels, kinds[kind]["launches"])) != set(
                    MESH_KERNELS):
                raise AssertionError(f"mesh_path: the {kind} kind launched "
                                     f"{kinds[kind]['launches']}")
        res, record, bv = phase_stream(
            torch, kernels, fixture, BatchVerifier, MESH_BATCHES,
            "mesh_path", MESH_KERNELS, decomp=False, mesh=mesh)
        res.update(mesh={"size": mesh.size, "backend": mesh.backend,
                         "device": str(mesh.device)},
                   mesh_wire_stats=bv.mesh_wire_stats, msm_kinds=kinds)
        tamper = phase_tamper(torch, kernels, BatchVerifier, fixture,
                              "tampered_batch_mesh", mesh=mesh)
    finally:
        dist.shutdown()
    return res, record, tamper


def phase_mesh_ranks(torch, np, card, case, forest_inputs, msm_forest):
    """MESH_RANKS gloo ranks sharing the card: this script run with
    --mesh-rank in MESH_RANKS subprocesses (the kernels are built), each
    on cuda:0; they read phase 4's MSM and its answers from a temporary
    directory and write their reports there. Any rank failing fails the
    phase. Returns the line and each rank's launches over its three MSM
    kinds and its stream."""
    single = forest_inputs[-1]
    s_np, x, y, sizes, want = case
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="h2v_mesh_") as work:
        np.savez(os.path.join(work, "case.npz"), s=s_np, x=x, y=y,
                 sizes=np.asarray(sizes), single=single,
                 want=np.asarray([[str(c) for c in p] for p in want]))
        procs, logs = [], []
        for r in range(MESH_RANKS):
            env = dict(os.environ, H2V_COORDINATOR=f"127.0.0.1:{port}",
                       H2V_NUM_PROCESSES=str(MESH_RANKS),
                       H2V_PROCESS_ID=str(r), LOCAL_RANK=str(r))
            # a file, not a pipe: a rank that writes much must not block
            # before its collectives
            logs.append(os.path.join(work, f"rank{r}.log"))
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--mesh-rank", str(r), "--mesh-dir", work], cwd=HERE,
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            for p in procs:
                try:
                    p.wait(timeout=max(
                        MESH_RANK_TIMEOUT_S - (time.perf_counter() - t0), 1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for path in logs:
            with open(path) as f:
                outs.append(f.read())
        bad = [f"rank {r} exit {p.returncode}: {o[-3000:]}"
               for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
        if bad:
            raise AssertionError("mesh_ranks_path: " + "\n".join(bad))
        reports = []
        for r in range(MESH_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    res = {"phase": "mesh_ranks_path", "ranks": MESH_RANKS,
           "backend": "gloo", "device": reports[0]["device"],
           "rate_label": MESH_RANKS_LABEL.format(ranks=MESH_RANKS,
                                                 card=card.name),
           "proofs_per_s_steady_by_rank": [
               rep["stream"]["proofs_per_s_steady"] for rep in reports],
           "tampered_failed_indices_by_rank": [
               rep["tampered_failed_indices"] for rep in reports],
           "seconds": round(time.perf_counter() - t0, 3),
           "by_rank": reports}
    return res, [rep["launches"] for rep in reports]


def mesh_rank_main(torch, np, rank, work):
    """One rank of mesh_ranks_path: its group from the H2V_* variables
    (gloo, cuda:{LOCAL_RANK % device count}); phase 4's MSM in the
    windows, forest and scan (u16) kinds, each kind's launches counted
    on this rank; rank 0 holds the windows kind's totals to the
    single-device forest's bit for bit; every kind's points equal the
    host MSM's; then a MESH_RANK_BATCHES-batch stream, every batch ok,
    and the tampered batch failing at TAMPER_INDEX. Writes
    rank<R>.json into `work`; raises on any failure."""
    from halo2_verifier_tpu_torch import weights
    from halo2_verifier_tpu_torch.ops import kernels
    from halo2_verifier_tpu_torch.ops.constants import R
    from halo2_verifier_tpu_torch.parallel import dist, mesh as pmesh
    from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier

    if not dist.init_distributed(backend="gloo", timeout=300):
        raise AssertionError(f"rank {rank}: no process group formed")
    try:
        mesh = pmesh.make_mesh(MESH_RANKS)
        if (mesh.rank, mesh.device.type) != (rank, "cuda"):
            raise AssertionError(f"rank {rank}: mesh {mesh}")
        z = np.load(os.path.join(work, "case.npz"))
        sizes = [int(v) for v in z["sizes"]]
        want = [tuple(int(c) for c in p) for p in z["want"]]
        fixture = weights.load_k14_mac_fixture()
        params, vk, items = fixture
        report = {"rank": rank, "device": str(mesh.device), "kinds": {}}
        expect = {"windows": MESH_KERNELS, "forest": MESH_KERNELS,
                  "scan": ("mont_mul", "point_add")}
        for kind, shard in (("windows", None), ("forest", "forest"),
                            ("scan", "scan")):
            bv = BatchVerifier(params, vk, mesh=mesh, mesh_shard=shard)
            kernels.reset_launches()
            t0 = time.perf_counter()
            handle = bv._dispatch_limbs(z["s"], z["x"], z["y"], sizes)
            got = bv._collect_pair(handle)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            if got != want:
                raise AssertionError(f"rank {rank}: the {kind} kind "
                                     "differs from the host MSM")
            if set(kernel_counts(kernels, launches)) != set(expect[kind]):
                raise AssertionError(f"rank {rank}: the {kind} kind "
                                     f"launched {launches}")
            line = {"handle": handle[0], "seconds": round(dt, 4),
                    "equal_to_host_msm": True, "launches": launches,
                    "wire": bv.mesh_wire_stats}
            if kind == "windows" and rank == 0:
                totals = pmesh.windows_in_order(bv._fetch(handle[1]),
                                                len(sizes))
                if not (totals == z["single"]).all():
                    raise AssertionError("rank 0: the windows kind's totals "
                                         "differ from the single-device "
                                         "forest's")
                line["totals_equal_single_device"] = True
            report["kinds"][kind] = line
        batch = tile(items, BATCH)
        bv = BatchVerifier(params, vk, mesh=mesh)
        kernels.reset_launches()
        stamps = []
        t0 = time.time()
        for r in bv.verify_stream(batch for _ in range(MESH_RANK_BATCHES)):
            stamps.append(time.time())
            if not r.ok:
                raise AssertionError(f"rank {rank}: batch {len(stamps)} "
                                     "failed")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if "host_assemble" not in bv.timings.totals:
            raise AssertionError(f"rank {rank}: the VM fast path did not "
                                 "serve the stream")
        for name, n in kernel_counts(kernels, launches).items():
            if (name in MESH_KERNELS) != (n > 0):
                raise AssertionError(f"rank {rank}: stream launched {name} "
                                     f"{n} times")
        if bv.decomp_points_dispatched:
            raise AssertionError(f"rank {rank}: the sqrt pre-pass ran")
        report["stream"] = {
            "batches": MESH_RANK_BATCHES, "batch_size": BATCH,
            "all_ok": True,
            "proofs_per_s_steady": round((len(stamps) - 1) * BATCH
                                         / (stamps[-1] - stamps[0]), 1),
            "wall_seconds": round(stamps[-1] - t0, 3),
            "stages": bv.timings.report(),
            "mesh_wire_stats": bv.mesh_wire_stats,
            "launches": launches}
        tamper = tile(items, TAMPER_BATCH)
        p, inst = tamper[TAMPER_INDEX]
        tamper[TAMPER_INDEX] = (p, [[(inst[0][0] + 1) % R] + inst[0][1:]])
        (res,) = list(BatchVerifier(params, vk, mesh=mesh).verify_stream(
            [tamper]))
        if res.ok or res.failed_indices != [TAMPER_INDEX]:
            raise AssertionError(f"rank {rank}: tampered batch ok={res.ok} "
                                 f"failed={res.failed_indices}")
        report["tampered_failed_indices"] = res.failed_indices
        report["launches"] = {
            name: launches[name] + sum(k["launches"].get(name, 0)
                                       for k in report["kinds"].values())
            for name in launches}
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.shutdown()


# name, source, TPU kernel it replaces, the path whose run gives its row
KERNELS = (
    ("forest_frontier0", "halo2_verifier_tpu_torch/csrc/frontier.cu",
     "halo2_verifier_tpu/ops/lmfield.py:440 (K1's use in "
     "halo2_verifier_tpu/ops/msm_forest.py:342 _convert_points, with "
     ":353 _gather0)", "main_path"),
    ("point_add", "halo2_verifier_tpu_torch/csrc/point_add.cu",
     "halo2_verifier_tpu/ops/lmcurve.py:73", "main_path"),
    ("sqrt_principal", "halo2_verifier_tpu_torch/csrc/mont_mul.cu",
     "halo2_verifier_tpu/ops/lmfield.py:440 (via "
     "halo2_verifier_tpu/ops/decomp_jax.py:54)", "main_path"),
    ("mont_mul", "halo2_verifier_tpu_torch/csrc/mont_mul.cu",
     "halo2_verifier_tpu/ops/lmfield.py:440", "scan_path_u16"),
    ("point_double", "halo2_verifier_tpu_torch/csrc/point_double.cu",
     "halo2_verifier_tpu/ops/lmcurve.py:273", "double_path"),
    ("mont_mul8", "halo2_verifier_tpu_torch/csrc/mont_mul8.cu",
     "halo2_verifier_tpu/ops/lmfield8.py:257", "scan_path_f8"),
    ("point_add8", "halo2_verifier_tpu_torch/csrc/point_add8.cu",
     "halo2_verifier_tpu/ops/lmcurve.py:73 (instance OPS8, :213)",
     "scan_path_f8"),
    # the device pairing's tower: no Pallas kernel in the reference (XLA
    # fuses its pairing program); the code each kernel replaces
    ("fq_addsub", "halo2_verifier_tpu_torch/csrc/tower.cu",
     "none (XLA): halo2_verifier_tpu/ops/pairing_jax.py:44 _fadd, :48 "
     "_fsub, :52 _fneg", "device_pairing_path"),
    ("fq12_mul", "halo2_verifier_tpu_torch/csrc/tower.cu",
     "none (XLA): halo2_verifier_tpu/ops/pairing_jax.py:461 fq12_mul "
     "(its maps, :245, with :211 _reduce_mod_p, and the K1 product of "
     "halo2_verifier_tpu/ops/lmfield.py:440)", "device_pairing_path"),
    ("fq_inv", "halo2_verifier_tpu_torch/csrc/tower.cu",
     "none (XLA): halo2_verifier_tpu/ops/pairing_jax.py:56 _finv "
     "(halo2_verifier_tpu/ops/lmfield.py:474 inv_mont)",
     "device_pairing_path"),
    ("miller_step", "halo2_verifier_tpu_torch/csrc/tower.cu",
     "none (XLA): halo2_verifier_tpu/ops/pairing_jax.py:585 _line_double "
     "and :605 _line_add (their Fq adds, the K1 products of "
     "halo2_verifier_tpu/ops/lmfield.py:440 and :474 inv_mont)",
     "device_pairing_path"),
)


# the CUDA function each wrapper launches (a substring of the profiler's
# kernel name)
KERNEL_FN = {
    "mont_mul": "mont_mul_kernel", "mont_mul8": "mont_mul8_kernel",
    "point_add": "point_add_kernel", "point_add8": "point_add_kernel",
    "point_double": "point_double_kernel",
    "sqrt_principal": "sqrt_principal_kernel",
    "forest_frontier0": "frontier0_kernel",
    "fq_addsub": "fq_addsub_kernel",
    "fq12_mul": "fq12_mul_kernel", "fq_inv": "fq_inv_kernel",
    "miller_step": "miller_step_kernel",
}


def kernel_ms(torch, name, fn):
    """(ms, basis, CUDA-event ms) of one launch of kernel `name` by fn:
    the profiler's device time per launch, and beside it the CUDA events
    around 20 back-to-back calls (host dispatch included); the events'
    time stands in only where the profiler shows no launch."""
    ev_ms = time_ms(torch, fn, reps=20)
    ms = device_ms(torch, fn, KERNEL_FN[name])
    return (ev_ms, "cuda_events", ev_ms) if ms is None else (
        ms, "profiler_device_time", ev_ms)


def kernel_case(name, args, curve, fm, f8, decomp):
    """(plain version, bytes, (multiply-adds, ALU, FP32) operations) of
    one recorded launch: each input read once and each output written
    once; operations as this launch's data needs them (a masked-out lane
    of the point add only copies its point)."""
    if name in ("mont_mul", "mont_mul8"):
        a, bb, field_id = args
        spec = fm.FQ if field_id == 0 else fm.FR
        elem, load, store = FORMAT[name]
        b = a.shape[1]
        if name == "mont_mul":
            def plain():
                return fm.mont_mul_body(a.long(), bb.long(), spec).int()
        else:
            def plain():
                return f8.mont_mul_body(a, bb, spec)
        return plain, 3 * elem * b, ops((b, MONT_MUL), (2 * b, load),
                                        (b, store))
    if name in ("point_add", "point_add8"):
        p, q, mask, iL, iR = args  # as PointOps.masked_add calls it
        ops_ = curve.OPS16 if name == "point_add" else curve.OPS8
        elem, load, store = FORMAT[name]

        def plain():
            return ops_.masked_add_plain(p, q, mask, iL, iR)

        wp, wq = p[0].shape[1], q[0].shape[1]
        b = iL.shape[0] if iL is not None else (
            iR.shape[0] if iR is not None else wp)
        same = p[0].data_ptr() == q[0].data_ptr()
        nbytes = (3 * elem * (wp + (0 if same else wq))
                  + 4 * b * ((iL is not None) + (iR is not None))
                  + (b if mask is not None else 0)
                  + 3 * elem * b)
        active = b if mask is None else int(mask.sum())
        # RCB15 alg. 7: 12 products, 27 adds/subtracts, 6 loads and 3
        # stores; a masked-out lane loads and stores its point
        return plain, nbytes, ops((12 * active, MONT_MUL),
                                  (27 * active, ADD_SUB), (3 * active, load),
                                  (3 * b, load), (3 * b, store))
    if name == "fq_addsub":
        a, bb, op = args
        body = {0: fm.add_body, 1: fm.sub_body}
        if op == 2:
            def plain():
                return fm.neg_body(a.long(), fm.FQ).int()
        else:
            def plain():
                return body[op](a.long(), bb.long(), fm.FQ).int()
        b = a.shape[1]
        n_in = 1 if op == 2 else 2
        return plain, (n_in + 1) * LIMB_BYTES * b, ops(
            (b, ADD_SUB), (n_in * b, LOAD16), (b, STORE16))
    if name == "fq12_mul":
        from halo2_verifier_tpu_torch.ops import pairing

        a, bb = args
        b = a.shape[2]
        n_in = 1 if a.data_ptr() == bb.data_ptr() else 2
        # the function: the operand maps, the 54 products, the
        # recombination map (ops_linmap); MA equals MB, so a square maps
        # its operand once and squares; 24 (or, for a square, 12)
        # coefficients loaded, 12 stored
        if n_in == 1:
            operands = ops((1, ops_linmap(pairing._FQ12_MA)), (54, MONT_SQR))
        else:
            operands = ops((1, ops_linmap(pairing._FQ12_MA)),
                           (1, ops_linmap(pairing._FQ12_MB)), (54, MONT_MUL))
        return (lambda: pairing.fq12_mul_plain(a, bb),
                LIMB_BYTES * 12 * (n_in + 1) * b,
                ops((b, operands), (b, ops_linmap(pairing._FQ12_MC)),
                    (12 * n_in * b, LOAD16), (12 * b, STORE16)))
    if name == "fq_inv":
        a, field_id = args
        spec = fm.FQ if field_id == 0 else fm.FR
        # the shortest fixed-window chain for N - 2 (the kernel's 3-bit
        # window is it for Fq: 253 squarings, 71 products; and its two
        # conversions between radixes are left out)
        squarings, multiplies = inv_chain_counts(spec.modulus - 2)
        b = a.shape[1]
        return (lambda: fm.inv_mont_body(a.long(), spec).int(),
                2 * LIMB_BYTES * b,
                ops((b * squarings, MONT_SQR), (b * multiplies, MONT_MUL),
                    (b, LOAD16), (b, STORE16)))
    if name == "miller_step":
        from halo2_verifier_tpu_torch.ops import pairing

        mode, t, q, px, py = args
        b = t.shape[2]
        # T (and Q when adding) and P read once, T' and the 12 line
        # coefficients written once
        n_in = 6 if q is None else 10
        return (lambda: pairing.miller_step_plain(mode, t, q, (px, py)),
                LIMB_BYTES * (n_in + 16) * b,
                ops((b, ops_miller_step(mode)), (n_in * b, LOAD16),
                    (16 * b, STORE16)))
    if name == "point_double":
        (p,) = args
        b = p[0].shape[1]
        return (lambda: curve.double_plain(p), 2 * 3 * LIMB_BYTES * b,
                ops((b, OPS_POINT_DOUBLE)))
    if name == "forest_frontier0":
        from halo2_verifier_tpu_torch.ops import msm_forest

        xs, ys, idx = args
        n, w0 = xs.shape[1], idx.shape[0]
        # the points and the index read once, the frontier written once;
        # per output lane two products, two loads, three stores
        return (lambda: msm_forest.frontier0_plain(xs, ys, idx),
                2 * LIMB_BYTES * n + 4 * w0 + 3 * LIMB_BYTES * w0,
                ops((2 * w0, MONT_MUL), (2 * w0, LOAD16), (3 * w0, STORE16)))
    (xs,) = args
    b = xs.shape[1]
    return (lambda: decomp.y_principal_plain(xs), 2 * LIMB_BYTES * b,
            ops((b, ops_sqrt(*decomp.sqrt_chain_counts()))))


def time_kernel(torch, card, kernels, name, record, curve, fm, f8, decomp):
    """One kernel at its widest recorded launch's own arguments: the
    kernel, the plain version on the same inputs, and the bound for those
    inputs."""
    b, args = record["widest"][name]
    fn = getattr(kernels, name)
    plain, nbytes, counts = kernel_case(name, args, curve, fm, f8, decomp)
    err = max_abs_err(torch, fn(*args), plain())
    ms, ms_basis, events_ms = kernel_ms(torch, name, lambda: fn(*args))
    plain_ms = time_ms(torch, plain, reps=1 if name in (
        "sqrt_principal", "fq_inv", "miller_step") else 3)
    bound_ms, bound_by = card.bound(nbytes, counts)
    n = record["batches"]
    extra = {}
    if name == "sqrt_principal":
        # one warp alone: how far the launch is from one chain's latency
        one_warp = args[0][:, :32].contiguous()
        ms32, _, _ = kernel_ms(torch, name, lambda: fn(one_warp))
        squarings, multiplies = decomp.sqrt_chain_counts()
        extra = {"ms_32_lanes": round(ms32, 4),
                 "ms_over_ms_32_lanes": round(ms / ms32, 3),
                 "chain": {"window_bits": decomp.SQRT_WINDOW,
                           "squarings": squarings,
                           "multiplies": multiplies}}
    return {
        "launches": record["launches"][name],
        "launches_per_batch": round(record["launches"][name] / n, 2),
        "lanes": b, "max_abs_err": err, "ms": sig(ms), "ms_basis": ms_basis,
        "events_ms": round(events_ms, 4),
        "plain_ms": round(plain_ms, 4), "bound_ms": sig(bound_ms),
        "bound_by": bound_by, "share": round(bound_ms / ms, 4),
        "library_ms": None,
        "bytes": nbytes, "operations": sum(counts),
        "operations_by_pipe": dict(zip(("imad", "alu", "fp32"), counts)),
        "lanes_per_batch": round(record["lanes"][name] / n),
        **extra,
    }


def phase_timings(torch, card, kernels, records, curve, fm, f8, decomp):
    """The kernels' rows, each on its own path's record; the 16-bit-limb
    point add once more at the scan path's widest launch, to stand beside
    the 8-bit-limb one on the same work, and K1 at the device pairing's
    widest launch."""
    rows = []
    for name, src, replaces, path in KERNELS:
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "path": path,
                     **time_kernel(torch, card, kernels, name, records[path],
                                   curve, fm, f8, decomp)})
    beside = [{"phase": "timing_scan_path_u16_point_add",
               "name": "point_add", "path": "scan_path_u16",
               **time_kernel(torch, card, kernels, "point_add",
                             records["scan_path_u16"], curve, fm, f8,
                             decomp)},
              {"phase": "timing_device_pairing_path_mont_mul",
               "name": "mont_mul", "path": "device_pairing_path",
               **time_kernel(torch, card, kernels, "mont_mul",
                             records["device_pairing_path"], curve, fm, f8,
                             decomp)}]
    return rows, beside


def phase_point_add_widths(torch, card, kernels, record, curve, fm, f8,
                           decomp):
    """K2 at POINT_ADD_TIMED_WIDTHS lanes, in whichever shape the
    launcher takes there: the main path's widest point-add launch cut to
    its first n lanes, each reading a frontier of just the 2n points they
    gather (so the bound counts the bytes the lanes need), timed as its
    own row."""
    _b, (p, _q, _mask, iL, iR) = record["widest"]["point_add"]
    below = kernels.narrow_below()
    rows = []
    for n in POINT_ADD_TIMED_WIDTHS:
        idx = torch.cat([iL[:n], iR[:n]]).long()
        f = tuple(c.index_select(1, idx).contiguous() for c in p)
        lanes = torch.arange(2 * n, dtype=torch.int32, device=iL.device)
        cut = (f, f, None, lanes[:n], lanes[n:])
        rows.append({"phase": f"timing_point_add_{n}_lanes",
                     "name": "point_add", "path": "main_path",
                     "shape": "narrow" if n < below else "wide",
                     "narrow_below": below,
                     **time_kernel(torch, card, kernels, "point_add",
                                   {**record,
                                    "widest": {"point_add": (n, cut)}},
                                   curve, fm, f8, decomp)})
    return rows


def device_times(prof):
    """Device time in microseconds by kernel or copy name, from a
    torch.profiler profile."""
    from torch.autograd import DeviceType

    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total
    return dev


def stage_ms(torch, fn, reps=10):
    """A device stage's stream time per call (CUDA events around `reps`
    calls, host enqueue and uploads included) and the device's busy time
    per call, in all and by kernel name (the profiler's device-side events
    over 3 further calls; None where the profiler reports no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(torch, fn, reps=reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    dev = device_times(prof)
    busy = sum(dev.values()) / 1e3 / 3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    return {"ms_per_batch": round(ms, 4),
            "device_busy_ms_per_batch": round(busy, 4) if busy else None,
            "device_ms_per_batch_by_name": {
                k[:60]: round(v / 1e3 / 3, 4) for k, v in top}}


def phase_forest_batch(torch, msm_forest, forest_inputs, case):
    """The whole device stage (pack, upload, conversion, forest levels,
    bucket phase) of the batch-sized forest of phase 4 on its pinned plan,
    through one slot of recordings."""
    plan_scalars, _x, _y, sizes, _want = case
    x_np, y_np, plan, dev, _totals = forest_inputs
    pinned, _pin = msm_forest.pin_plan_widths(
        msm_forest.host_plan(plan_scalars, sizes))
    recs = msm_forest.ForestRecordings()
    return {"phase": "timing_forest_batch",
            **stage_ms(torch, lambda: msm_forest.dispatch_planned(
                x_np, y_np, pinned, dev, recordings=recs)),
            "basis": "pack, one H2D copy and one replay per call; the "
                     "first call records",
            "recordings": recs.recorded, "replays": recs.replays,
            "recording_pool_bytes": recs.pool_bytes(),
            "forest_levels": len(plan["levels"]),
            "level0_lanes": int(plan["point_idx0"].shape[0]),
            "entries": int(plan["entries"]), "plan_adds": int(plan["adds"])}


def phase_scan_batch(torch, msm_scan, scan_inputs, backend):
    """The whole device stage (uploads, gather, conversion, segmented
    scan, bucket suffix scans) of the batch-sized scan MSM of phase 4 in
    one limb backend, on its inputs."""
    x_np, y_np, idx, keys, groups, levels, dev = scan_inputs
    return {"phase": f"timing_scan_batch_{backend}",
            **stage_ms(torch, lambda: msm_scan.msm_window_totals_grouped(
                x_np, y_np, idx, keys, groups, levels, dev,
                backend=backend)),
            "lanes": int(idx.shape[0]),
            "levels": levels,
            "point_add_lanes": msm_scan.scan_lanes(
                int(idx.shape[0]), groups * 32, levels)}


def phase_profile(torch, kernels, bv, fixture, n_batches):
    """Device busy share of a whole stream on the warm verifier of the
    main path: the profiler's device-side events (kernels and copies)
    over the stream's wall time, and device time by kernel name. The
    trace also holds the counters to the device: each forest kernel's
    events in it must equal the launches its wrapper counted in the
    stream (the replays times the launches each recording holds), FOREST_PER_BATCH per batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _params, _vk, items = fixture
    batch = tile(items, BATCH)
    before = dict(kernels.LAUNCHES)
    replays = bv.forest_recordings.replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for r in bv.verify_stream(batch for _ in range(n_batches)):
            if not r.ok:
                raise AssertionError("profiled batch failed")
        torch.cuda.synchronize()
        wall = time.time() - t0
    counted = {k: kernels.LAUNCHES[k] - before[k] for k in FOREST_PER_BATCH}
    traced = dict.fromkeys(FOREST_PER_BATCH, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k, name in FOREST_TRACE_NAMES.items():
                traced[k] += name in e.name
    want = {k: n * n_batches for k, n in FOREST_PER_BATCH.items()}
    if not traced == counted == want:
        raise AssertionError(f"profile: kernel events in the trace {traced}, "
                             f"launches counted {counted}, expected {want}")
    dev = device_times(prof)
    busy_s = sum(dev.values()) / 1e6
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {"phase": "profile", "batches": n_batches,
            "wall_seconds": round(wall, 4),
            "device_busy_seconds": round(busy_s, 4) if dev else None,
            "device_busy_share": round(busy_s / wall, 4) if dev else None,
            "replays": bv.forest_recordings.replays - replays,
            "kernel_events_traced": traced, "launches_counted": counted,
            "device_ms_per_batch_by_name": {
                k[:60]: round(v / 1e3 / n_batches, 3) for k, v in top}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=32,
                    help="main-path stream batches (>= 4)")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # one rank of mesh_ranks_path
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.batches < 4:
        ap.error("--batches must be at least 4")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from halo2_verifier_tpu_torch.parallel.orchestrator import (
            BatchVerifier)
    except ImportError as e:
        print(f"chip_smoke: the package halo2_verifier_tpu_torch is not "
              f"beside this script ({e}); nothing was run", file=sys.stderr)
        return 3

    if args.mesh_rank is not None:
        import numpy as np

        mesh_rank_main(torch, np, args.mesh_rank, args.mesh_dir)
        return 0
    card = Card(torch)
    run(torch, card, torch.device("cuda"), args.batches, BatchVerifier)
    return 0


def run(torch, card, dev, n_batches, make_verifier):
    """Every phase, on `dev`; raises on the first failure. Prints the
    phase lines, the kernels' record and the final ok line."""
    import numpy as np

    from halo2_verifier_tpu_torch import weights
    from halo2_verifier_tpu_torch.ops import (
        curve, curve_minor, decomp, field as fm, field8 as f8, field_minor,
        hostcurve as hc, hostpairing as hp, kernels, msm, msm_forest,
        msm_scan, pairing)
    from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

    def emit(res):
        out({**res, **tag})
        if res.get("max_abs_err", 0) != 0:
            raise AssertionError(f"{res['phase']}: kernel differs from its "
                                 "plain version")
        return res

    t_start = time.time()
    tag = card.tag()
    out({"phase": "card", "nvidia_smi": card.smi, "torch_name": card.name,
         "sms": card.sms, "sm_max_mhz": card.sm_mhz,
         "torch": torch.__version__, "cuda": torch.version.cuda})
    emit(phase_build(kernels))
    emit(phase_k1(torch, np, fm, ints_to_limbs, dev))
    for width in (POINT_ADD_WIDTH, POINT_ADD_NARROW_WIDTH):
        emit({**phase_k2(torch, np, hc, fm, curve, ints_to_limbs, dev,
                         width),
              "shape": "narrow" if width < kernels.narrow_below()
              else "wide"})
    emit(phase_sqrt(torch, np, hc, fm, curve, ints_to_limbs, decomp, dev))
    if not emit(phase_k3(torch, np, hc, fm, curve, ints_to_limbs, dev,
                         POINT_DOUBLE_WIDTH))["double_equals_self_add_affine"]:
        raise AssertionError("2P differs from P + P as affine points")
    emit(phase_k4(torch, np, fm, f8, ints_to_limbs, dev))
    emit(phase_k5(torch, np, hc, fm, f8, curve, ints_to_limbs, dev,
                  SCAN_LANES))
    emit(phase_tower(torch, np, card, fm, pairing, kernels, ints_to_limbs,
                     dev))
    emit(phase_pairing(torch, np, card, pairing, hp, hc, kernels, dev))
    forest_res, forest_inputs, case = phase_forest(
        torch, np, hc, msm_forest, msm, ints_to_limbs, dev)
    if not emit(forest_res)["equal_to_host_msm"]:
        raise AssertionError("forest MSM differs from the host MSM")
    emit(phase_frontier(torch, np, msm_forest, forest_inputs, dev))
    emit(phase_packed_parity(torch, np, hc, kernels, msm, msm_forest, case))
    scan_res, scan_inputs = phase_scan_msm(torch, msm_scan, msm, weights,
                                           case, dev)
    emit(scan_res)
    if not (all(scan_res["equal_to_host_msm"].values())
            and scan_res["f8_totals_equal_relimbed_u16_totals"]):
        raise AssertionError("scan MSM differs from the host MSM, or its "
                             "f8 totals from the re-limbed u16 totals")

    fixture = weights.load_k14_mac_fixture()
    records = {}
    k9_records = {}
    main_res, records["main_path"], bv = phase_stream(
        torch, kernels, fixture, make_verifier, n_batches, "main_path",
        FOREST_KERNELS)
    emit(main_res)
    emit(phase_tamper(torch, kernels, make_verifier, fixture,
                      "tampered_batch"))
    for backend, expect in (("u16", ("mont_mul", "point_add",
                                      "sqrt_principal")),
                            ("f8", ("mont_mul8", "point_add8",
                                    "sqrt_principal"))):
        path = f"scan_path_{backend}"
        res, records[path], _bv = phase_stream(
            torch, kernels, fixture, make_verifier, SCAN_BATCHES[backend],
            path, expect, msm="scan", limb_backend=backend)
        emit(res)
    emit(phase_tamper(torch, kernels, make_verifier, fixture,
                      "tampered_batch_scan", msm="scan"))
    double_res, records["double_path"] = phase_double_path(
        torch, np, hc, fm, curve, kernels, ints_to_limbs, dev)
    emit(double_res)
    res, records["device_pairing_path"], _bv = phase_stream(
        torch, kernels, fixture, make_verifier, DEVICE_PAIRING_BATCHES,
        "device_pairing_path",
        ("forest_frontier0", "point_add", "sqrt_principal", "mont_mul",
         "fq_addsub", "fq12_mul", "fq_inv", "miller_step"),
        pairing="device")
    emit(res)
    emit(phase_tamper(torch, kernels, make_verifier, fixture,
                      "tampered_batch_device_pairing", pairing="device"))
    emit(phase_single(torch, kernels, make_verifier, fixture))
    minor_res, minor_record = phase_minor_path(
        torch, np, hc, fm, field_minor, curve_minor, curve, kernels,
        ints_to_limbs, limbs_to_ints, dev)
    emit(minor_res)

    # bench.py's k=9 configurations and the verify command; their launch
    # counts stand beside each kernel's row, whose timing stays on the
    # k=14 path's widest launch
    k9_line, k9 = k9_workloads()
    emit(k9_line)
    keccak_gwc = (k9["params"], k9["mac_vk"], k9["keccak_gwc"])
    res, k9_records["keccak_gwc_path"], _bv = phase_stream(
        torch, kernels, keccak_gwc, make_verifier, K9_BATCHES,
        "keccak_gwc_path", FOREST_KERNELS, batch_size=K9_BATCH,
        multiopen="gwc", hash_name="keccak256")
    emit(res)
    emit(phase_tamper(torch, kernels, make_verifier, keccak_gwc,
                      "tampered_batch_keccak_gwc", multiopen="gwc",
                      hash_name="keccak256"))
    # vk=None: every item carries its own vk; TAMPER_INDEX is odd, so the
    # tampered proof is a vector_mul one
    mixed = (k9["params"], None, k9["mixed"])
    res, k9_records["hetero_vk_path"], _bv = phase_stream(
        torch, kernels, mixed, make_verifier, K9_BATCHES, "hetero_vk_path",
        FOREST_KERNELS, batch_size=K9_BATCH)
    emit(res)
    emit(phase_tamper(torch, kernels, make_verifier, mixed,
                      "tampered_batch_hetero_vk"))
    cli_res = phase_cli(torch, kernels, k9)
    k9_records["cli_path"] = {
        "launches": cli_res["verify_keccak_gwc"]["launches"]}
    emit(cli_res)

    # the mesh on the one card: a world of one NCCL rank here, then four
    # gloo ranks sharing the card; their launches stand beside each row
    mesh_res, mesh_record, mesh_tamper = phase_mesh_path(
        torch, np, kernels, msm_forest, fixture, make_verifier,
        forest_inputs, case)
    emit(mesh_res)
    emit(mesh_tamper)
    ranks_res, ranks_launches = phase_mesh_ranks(
        torch, np, card, case, forest_inputs, msm_forest)
    emit(ranks_res)

    rows, beside = phase_timings(torch, card, kernels, records, curve, fm,
                                 f8, decomp)
    for r in rows:
        r["launches_k9_paths"] = {
            path: rec["launches"].get(r["name"], 0)
            for path, rec in k9_records.items()}
        r["launches_mesh_paths"] = {
            "mesh_path": mesh_record["launches"].get(r["name"], 0),
            "mesh_ranks_path": [rank.get(r["name"], 0)
                                for rank in ranks_launches]}
        r["launches_minor_path"] = minor_record["launches"].get(r["name"], 0)
    emit(phase_forest_batch(torch, msm_forest, forest_inputs, case))
    for backend in ("u16", "f8"):
        emit(phase_scan_batch(torch, msm_scan, scan_inputs, backend))
    emit(phase_profile(torch, kernels, bv, fixture, n_batches))
    for r in rows:
        emit({"phase": f"timing_{r['name']}", **r})
    for r in beside:
        emit(r)
    for r in phase_point_add_widths(torch, card, kernels,
                                    records["main_path"], curve, fm, f8,
                                    decomp):
        emit(r)
    out({"phase": "done", "seconds": round(time.time() - t_start, 3), **tag})
    out(card.smi)
    out({"kernels": rows})
    out({"ok": True, "device": {"platform": "gpu", "kind": card.name,
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
