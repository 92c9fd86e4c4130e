"""sqrt_roofline: the least time of the square roots that the window's
proofs need, over the profiler's device time of the square-root kernel in
the window, in %.

Every compressed point of a proof (the reference counts them as its
transcript reads them, judge.facts) needs y = (x^3 + 3)^((p + 1) / 4):
one squaring, one product and one addition modulo p for x^3 + 3, then the
shortest chain known here for the exponent, the best left-to-right
sliding window over widths 1 to 10 (its table and its squarings and
products, counted exactly by sliding_counts). On 32-bit words (peaks.py's
pipes): a CIOS Montgomery product is 264 multiply-adds and 16 ALU
operations; a squaring 208 and 16 (36 word products for the square, 64
and 8 factors for the reduction, 2 multiply-adds each); an addition 24 ALU
operations. The bytes, 64 a lane, are far below the operations' time.
"""

from portbench.peaks import least_seconds

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
MONT_MUL = (264, 16)
MONT_SQR = (208, 16)
ADD_P = (0, 24)


def sliding_counts(e: int, w: int):
    """(squarings, products) of the left-to-right sliding-window power."""
    bits = bin(e)[2:]
    sq, mul = (1, (1 << (w - 1)) - 1) if w > 1 else (0, 0)
    i, first = 0, True
    while i < len(bits):
        if bits[i] == "0":
            sq += 1
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if not first:
            sq += j - i
            mul += 1
        first = False
        i = j
    return sq, mul


def lane_ops():
    best = None
    for w in range(1, 11):
        sq, mul = sliding_counts((P + 1) // 4, w)
        sq, mul = sq + 1, mul + 1   # x^3
        ops = tuple(sq * s + mul * m + a
                    for s, m, a in zip(MONT_SQR, MONT_MUL, ADD_P))
        best = ops if best is None or ops[0] < best[0] else best
    return best


def read(run):
    dev = run.device_seconds(lambda name: "sqrt" in name)
    if dev is None:
        return None
    lanes = run.facts["points_per_proof"] * sum(
        b.size for b in run.handed_in_window())
    imad, alu = lane_ops()
    return 100.0 * least_seconds(lanes * imad, lanes * alu) / dev
