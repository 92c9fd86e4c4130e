"""Frozen copy of halo2_verifier_tpu/ops/constants.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

BN254 (alt_bn128) curve and field constants.

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
