"""msm_roofline: the least time of the point additions that the window's
batch MSMs need, over the profiler's device time in the window of the
forest's kernels that make those additions (frontier0_kernel, which
converts the bases and adds the first level, and point_add_kernel, the
levels after it), in %. The gathers and scatters between levels, the
copies and the square root's kernel are left out of both sides.

The work is counted from the inputs, whatever implements the MSM. A batch
of n proofs gives each of the two accumulator MSMs n x (terms per proof) +
(terms every proof shares) entries of 254-bit scalars; the reference
counts both (judge.facts). For E entries the least additions are the best
bucket method over window widths c: ceil(254 / c) windows, each adding
every entry into one of 2^(c-1) signed-digit buckets (the first into a
bucket is free), then summing the buckets with a running sum,
2 (2^(c-1) - 1) additions, and the windows with one addition each; the
doublings between windows are left out. One addition at its least is the
complete mixed addition for a = 0 (Renes, Costello, Batina 2015,
algorithm 8): 11 products, 2 products by 3b and 13 additions modulo p.
On 32-bit words (peaks.py's pipes): a CIOS Montgomery product is 128 word
products of 2 multiply-adds and 8 reduction factors (264 multiply-adds) and
a conditional subtract of 16 ALU operations; a product by the small 3b is
8 word products and a reduction (32 multiply-adds, 16 ALU); an addition
modulo p is 24 ALU operations. Loads and stores are left out.

Counted per proof as if the window's proofs were all distinct: the
benchmark tiles a pack of distinct proofs, and the program does not merge
the copies. A window that holds a tampered batch gives no reading: the
bisection's sub-MSMs run on the same kernels, and the run does not record
their entries.
"""

from portbench.peaks import least_seconds

MONT_MUL = (264, 16)
MUL_3B = (32, 16)
ADD_P = (0, 24)
ADD_OPS = tuple(11 * m + 2 * b + 13 * a
                for m, b, a in zip(MONT_MUL, MUL_3B, ADD_P))
SCALAR_BITS = 254


def least_adds(entries: int) -> int:
    best = None
    for c in range(1, 17):
        windows = -(-SCALAR_BITS // c)
        buckets = 1 << (c - 1)
        adds = windows * (max(entries - buckets, 0) + 2 * (buckets - 1)) \
            + windows - 1
        best = adds if best is None else min(best, adds)
    return best


def batch_adds(n: int, facts: dict) -> int:
    return sum(least_adds(n * facts[f"{side}_terms_per_proof"]
                          + facts[f"{side}_terms_shared"])
               for side in ("left", "right"))


FOREST_KERNELS = ("frontier0_kernel", "point_add_kernel")


def forest_kernel(name: str) -> bool:
    return any(k in name for k in FOREST_KERNELS)


def read(run):
    handed = run.handed_in_window()
    if any(b.tampered for b in handed):
        return None
    dev = run.device_seconds(forest_kernel)
    if dev is None:
        return None
    adds = sum(batch_adds(b.size, run.facts) for b in handed)
    return 100.0 * least_seconds(adds * ADD_OPS[0], adds * ADD_OPS[1]) / dev
