"""BN254 (alt_bn128) curve and field constants.

These mirror the constants the reference inherits from its `halo2curves` fork
(reference: halo2_verifier/src/arithmetic.rs:1-3 re-exports ff/group/halo2curves).
All derived constants are computed here from first principles so the provenance
is auditable; the literals below are the standard, publicly documented BN254
parameters (EIP-196/197).
"""

# Base field modulus (Fq)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# Scalar field modulus (Fr)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter u: p(u), r(u) per the BN family polynomials
BN_U = 4965661367192848881
# Miller loop count for the optimal ate pairing
ATE_LOOP_COUNT = 6 * BN_U + 2  # 29793968203157093288

# Short Weierstrass: y^2 = x^3 + 3 over Fq
B_G1 = 3
# G1 generator
G1_GEN = (1, 2)

# Fq2 = Fq[u] / (u^2 + 1); the twist curve E'/Fq2: y^2 = x^3 + 3/(9+u)
# (D-type twist; xi = 9 + u)
XI = (9, 1)
# b' = 3 / (9 + u) as an Fq2 element (c0, c1)
B_G2 = (
    19485874751759354771024239261021720505790618469301721065564631296452457478373,
    266929791119991161246907387137283842545076965332900288569378510910307636690,
)
# G2 generator ((x_c0, x_c1), (y_c0, y_c1))
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# ff::PrimeField constants for Fr (as in the halo2curves bn256 Fr impl):
#   S: two-adicity; GENERATOR: multiplicative generator (7 for bn256 Fr);
#   ROOT_OF_UNITY = GENERATOR^((r-1) / 2^S);
#   DELTA = GENERATOR^(2^S)  (generator of the order-((r-1)/2^S) subgroup)
# referenced by poly/domain.rs:52 and plonk/permutation.rs:268.
FR_S = 28
FR_GENERATOR = 7
FR_T = (R - 1) >> FR_S  # odd cofactor
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_T, R)
FR_DELTA = pow(FR_GENERATOR, 1 << FR_S, R)
# WithSmallOrderMulGroup<3>: an element of multiplicative order 3
# (poly/domain.rs:79). Verification never depends on which of the two
# primitive cube roots is chosen; the prover only needs *a* coset generator.
FR_ZETA = pow(FR_GENERATOR, (R - 1) // 3, R)

# Montgomery radix used by halo2curves' 4x64-bit limb representation.
MONT_BITS = 256
MONT_R_FQ = (1 << MONT_BITS) % P
MONT_R_FR = (1 << MONT_BITS) % R
MONT_R_INV_FQ = pow(MONT_R_FQ, -1, P)
MONT_R_INV_FR = pow(MONT_R_FR, -1, R)

# sanity: p = 3 mod 4 makes sqrt easy; both true for BN254
assert P % 4 == 3
assert (R - 1) % (1 << FR_S) == 0 and FR_T % 2 == 1
assert pow(FR_ROOT_OF_UNITY, 1 << FR_S, R) == 1
assert pow(FR_ROOT_OF_UNITY, 1 << (FR_S - 1), R) != 1
assert pow(FR_ZETA, 3, R) == 1 and FR_ZETA != 1

# Canonical Fq values at the edges of the kernels' carry chains, operands
# of the parity checks (chip_smoke.py, tests/test_torch_*.py): the ends of
# the field, runs of one-words, q - 2^32, and the Fq pairs on which the
# reference's two-pass fold of m = T*N' leaves its top limb at exactly 2^16
# (m + 2^256), where the Montgomery product must still be canonical.
FOLD_EDGE = (
    (0x72326b6ab3bab60ef5716a3403b2e8ec463cb5cf3197882005dd3a2e3f08dae,
     0x1130a235f9489dda1703195ea5270f386b2e092699f440143a78c39876fcf955),
    (0x22ab954d281c53a985687f21f81c15dd9f8dfdcce53e053a8898e5717efbdbdf,
     0x4dd03bb06c69ba1cc78706a5ccad2a9456aa692f7ba47bb15fb5389df0af259),
    (0x294e32083f1f261fd12afbe8cffb7c84a3f6a95ce254b7c84e88414e33678c01,
     0x1248ed5d820d435d93774c4d22a5a63ac1b64a1f5afed180c65f372df67c3ced),
)
FQ_EDGE = ([0, 1, P - 1, P - 2] + [(1 << k) - 1 for k in (32, 64, 128, 253)]
           + [P - (1 << 32)] + [v for pair in FOLD_EDGE for v in pair])


def fq_edge_triples(strides):
    """Off-curve point pairs of FQ_EDGE values for the point add, which
    is plain field arithmetic on any canonical X, Y, Z: one 6-tuple
    (X1, Y1, Z1, X2, Y2, Z2) per lane. First six lanes in which the add's
    products X1*X2, Y1*Y2 and Z1*Z2 each multiply a FOLD_EDGE pair (the
    three pairs rotated over the coordinates, in both operand orders);
    then, for each stride s, lane j giving coordinate c the value
    FQ_EDGE[(j + s*c) % n], so each stride puts every value in every
    coordinate once."""
    n, k = len(FQ_EDGE), len(FOLD_EDGE)
    fold = []
    for side in (0, 1):
        for r in range(k):
            pairs = [FOLD_EDGE[(r + c) % k] for c in range(3)]
            fold.append(tuple(pair[side] for pair in pairs)
                        + tuple(pair[1 - side] for pair in pairs))
    return fold + [tuple(FQ_EDGE[(j + s * c) % n] for c in range(6))
                   for s in strides for j in range(n)]


def fq12_edge_pairs():
    """Fq12 operand pairs at the fused Fq12 multiply's edges, each
    operand 12 canonical Fq values in the coefficient stack's order:
    zero, a lone nonzero coefficient, each FOLD_EDGE pair in coefficient
    0 of the two operands (row 0 of both operand maps is coefficient 0
    alone, so product 0 multiplies that pair), and every FQ_EDGE value in
    every coefficient of both operands."""
    e, n = FQ_EDGE, len(FQ_EDGE)
    lone = tuple(e[2] if c == 5 else 0 for c in range(12))
    pairs = [((0,) * 12, (0,) * 12), (lone, tuple(e[:12])),
             (tuple(e[:12]), lone)]
    pairs += [((x,) + tuple(e[3:14]), (y,) + tuple(e[-11:]))
              for x, y in FOLD_EDGE]
    pairs += [(tuple(e[(j + 5 * c) % n] for c in range(12)),
               tuple(e[(j + 7 * c + 1) % n] for c in range(12)))
              for j in range(n)]
    return pairs


def miller_step_edge_lanes():
    """Miller step operands at the step's edges, one 10-tuple (xt0, xt1,
    yt0, yt1, xq0, xq1, yq0, yq1, px, py) of canonical Fq values per lane
    (the step is field arithmetic on any values): a zero denominator in
    each mode (yt = 0 when doubling; Q = T and Q = -T when adding, where
    the reference's inv(0) = 0 makes lambda 0), all zeros, then every
    FQ_EDGE value in every coordinate."""
    e, n = FQ_EDGE, len(FQ_EDGE)
    x0, x1, y0, y1 = e[4], e[9], e[11], e[2]
    lanes = [(x0, x1, 0, 0, e[5], e[6], e[7], e[8], e[2], e[3]),
             (x0, x1, y0, y1, x0, x1, y0, y1, e[2], e[3]),
             (x0, x1, y0, y1, x0, x1, (-y0) % P, (-y1) % P, e[1], e[12]),
             (0,) * 10]
    return lanes + [tuple(e[(j + 3 * c) % n] for c in range(10))
                    for j in range(n)]


def double_edge_triples():
    """(X, Y, Z) operands at the doubling's edges, canonical Fq values in
    Montgomery form (the doubling is field arithmetic on any triple): the
    identity (0 : R : 0), all zeros, a zero in each coordinate, each
    FOLD_EDGE pair in its products X*Y and Y*Z and its squares, then every
    FQ_EDGE value in every coordinate."""
    e, n = FQ_EDGE, len(FQ_EDGE)
    triples = [(0, MONT_R_FQ, 0), (0, 0, 0), (0, e[2], e[3]),
               (e[2], 0, e[3]), (e[2], e[3], 0), (P - 1, P - 1, P - 1)]
    for u, v in FOLD_EDGE:
        triples += [(u, v, v), (v, u, u), (u, u, v), (v, v, u)]
    return triples + [tuple(e[(j + s * c) % n] for c in range(3))
                      for s in (1, 2, 5) for j in range(n)]


def sqrt_edge_xs():
    """x operands at the square root's edges: FQ_EDGE, and the first x
    whose x^3 + 3 is a non-residue (off the curve: its root fails the
    VM's check)."""
    nonres = next(x for x in range(2, 100)
                  if pow((x ** 3 + 3) % P, (P - 1) // 2, P) == P - 1)
    return FQ_EDGE + [nonres]


assert all(0 <= v < P for v in FQ_EDGE)
