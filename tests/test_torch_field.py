"""PyTorch port, field layer (halo2_verifier_tpu_torch/ops/field.py):
the plain torch bodies against the JAX package's lmfield bodies on the same
seeded inputs, bit for bit, for Fq and Fr; the kernel constants against
the Python ones (the kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import lmfield as lf
from halo2_verifier_tpu.ops.field_jax import FQ as JFQ, FR as JFR
from halo2_verifier_tpu_torch.ops import constants, kernels
from halo2_verifier_tpu_torch.ops import field as fm
from halo2_verifier_tpu_torch.ops.constants import P, R
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain torch versions run many small ops: with one intra-op
    thread per process they do not fight the other test workers (and
    XLA's compile threads) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = [(JFQ, fm.FQ, P), (JFR, fm.FR, R)]
IDS = ["fq", "fr"]

# carry-ripple and boundary values (tests/test_lm_kernels.py:29)
ADVERSARIAL = [0, 1, 2, (1 << 16) - 1, (1 << 255) % P, P - 1, P - 2,
               (P + 1) // 2, 0xFFFF_FFFF_FFFF_FFFF]

# Fq pairs on which the reference's two-pass fold of m = T*N' leaves its
# top limb at exactly 2^16 (m + 2^256): the result must still be canonical
# (kept in the port's constants, which chip_smoke.py feeds to the card)
FOLD_EDGE = constants.FOLD_EDGE


def _operands(modulus, n=48, seed=0):
    rng = np.random.default_rng(seed)

    def draw(k):
        return [int.from_bytes(rng.bytes(32), "little") % modulus
                for _ in range(k)]

    a = draw(n - len(ADVERSARIAL)) + [v % modulus for v in ADVERSARIAL]
    b = draw(n)
    if modulus == P:
        a += [x for x, _ in FOLD_EDGE]
        b += [y for _, y in FOLD_EDGE]
    return a, b


def _np(vals):
    return np.ascontiguousarray(ints_to_limbs(vals).T)  # (16, B) uint32


def _torch(arr):
    return torch.from_numpy(arr.astype(np.int32))


def _ints(t):
    return limbs_to_ints(np.asarray(t).astype(np.int64).T)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_mont_mul_matches_reference(specs):
    jspec, tspec, modulus = specs
    a, b = _operands(modulus)
    A, B = _np(a), _np(b)
    want = np.asarray(lf.mont_mul_body(jnp.asarray(A), jnp.asarray(B), jspec))
    got = fm.mont_mul(_torch(A), _torch(B), tspec).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))
    rinv = pow(1 << 256, -1, modulus)
    assert _ints(got) == [x * y * rinv % modulus for x, y in zip(a, b)]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_add_sub_neg_match_reference(specs):
    jspec, tspec, modulus = specs
    a, b = _operands(modulus, seed=1)
    A, B = _np(a), _np(b)
    ja, jb = jnp.asarray(A), jnp.asarray(B)
    ta, tb = _torch(A), _torch(B)
    for want, got in (
        (lf.add_body(ja, jb, jspec), fm.add(ta, tb, tspec)),
        (lf.sub_body(ja, jb, jspec), fm.sub(ta, tb, tspec)),
        (lf.neg_body(ja, jspec), fm.neg(ta, tspec)),
    ):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int32))
    assert _ints(fm.sub(ta, tb, tspec)) == [
        (x - y) % modulus for x, y in zip(a, b)]


def test_inv_mont_matches_reference():
    rng = np.random.default_rng(2)
    vals = [0, 1, 2, P - 1] + [
        int.from_bytes(rng.bytes(32), "little") % P for _ in range(4)]
    mont = _np([v * fm.FQ.mont_r % P for v in vals])
    want = np.asarray(lf.inv_mont(jnp.asarray(mont), JFQ))
    got = fm.inv_mont(_torch(mont), fm.FQ).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_carry_prop_matches_reference_on_ripple_chains():
    rng = np.random.default_rng(7)
    for rows in (16, 17, 32, 33):
        x = rng.integers(0, 1 << 32, size=(rows, 16), dtype=np.uint64)
        x = x.astype(np.uint32)
        x[rng.random((rows, 16)) < 0.5] = 65535
        x[0][rng.random(16) < 0.5] = 0x2FFFF
        want = np.asarray(lf.carry_prop_static(jnp.asarray(x)))
        got = fm.carry_prop(torch.from_numpy(x.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        want2 = np.asarray(lf.carry_fold2(jnp.asarray(x)))
        got2 = fm.carry_fold2(torch.from_numpy(x.astype(np.int64)))
        np.testing.assert_array_equal(got2.numpy(), want2.astype(np.int64))


def test_spec_constants_match_reference():
    for jspec, tspec, _m in SPECS:
        for name in ("n_limbs", "ninv_limbs", "r_limbs", "r2_limbs"):
            assert getattr(tspec, name) == [
                int(v) for v in np.asarray(getattr(jspec, name))]
        assert tspec.inv_exp_bits == [
            int(v) for v in np.asarray(jspec.inv_exp_bits)]
    assert fm.FQ.sqrt_exp_bits == [
        int(v) for v in np.asarray(JFQ.sqrt_exp_bits)]


def _cuda_words(text, name):
    m = re.search(name + r"[^=]*=\s*\{(.*?)\};", text, re.S)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", m.group(1))]


def _words(v):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _limbs29(v):
    return [(v >> (29 * i)) & ((1 << 29) - 1) for i in range(9)]


def test_kernel_constants_match_python():
    """The CUDA sources hard-code the moduli and the Fq constants of the
    square-root kernel; they must equal the Python-derived values."""
    with open(os.path.join(kernels.CSRC_DIR, "field.cuh")) as f:
        fcuh = f.read()
    with open(os.path.join(kernels.CSRC_DIR, "mont_mul.cu")) as f:
        mcu = f.read()
    assert _cuda_words(fcuh, "MOD") == _words(P) + _words(R)
    assert _cuda_words(fcuh, "N0INV") == [
        (-pow(P, -1, 1 << 32)) % (1 << 32), (-pow(R, -1, 1 << 32)) % (1 << 32)]
    with open(os.path.join(kernels.CSRC_DIR, "frontier.cu")) as f:
        fcu = f.read()
    assert _cuda_words(fcu, "R2_FQ") == _words(fm.FQ.mont_r2)
    assert _cuda_words(fcu, "ONE_FQ") == _words(fm.FQ.mont_r)
    assert _cuda_words(mcu, "SQRT_EXP") == _words((P + 1) // 4)
    assert int(re.search(r"kSqrtBits = (\d+);", mcu).group(1)) == (
        ((P + 1) // 4).bit_length())
    # the square root's radix-2^29 form (csrc/mont29.cuh, for Fq and Fr),
    # Montgomery radix R' = 2^261
    with open(os.path.join(kernels.CSRC_DIR, "mont29.cuh")) as f:
        m29 = f.read()
    r29 = (1 << 261) % P
    assert _cuda_words(m29, "MOD29") == _limbs29(P) + _limbs29(R)
    assert _cuda_words(mcu, "R2_29") == _limbs29(r29 * r29 % P)
    assert _cuda_words(mcu, "B3_29") == _limbs29(3 * r29 % P)
    assert _cuda_words(m29, "NINV29") == [
        (-pow(n, -1, 1 << 29)) % (1 << 29) for n in (P, R)]


def test_kernel_wrapper_refuses_cpu_tensors():
    """A kernel wrapper never takes the plain version: CPU tensors are an
    error there (the plain path is chosen by the caller, ops/field.py)."""
    a = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.mont_mul(a, a, 0)
    with pytest.raises(ValueError):
        kernels.point_add((a, a, a), (a, a, a))
    with pytest.raises(ValueError):
        kernels.sqrt_principal(a)
    with pytest.raises(ValueError):
        kernels.forest_frontier0(a, a, torch.zeros(4, dtype=torch.int32))



def test_launch_counters_record_widest_launch():
    """The wrappers' bookkeeping: launches and lanes always; the widest
    launch's arguments only between reset_launches(record=True) and the
    next reset."""
    kernels.reset_launches(record=True)
    for lanes, tag in ((4, "a"), (9, "b"), (2, "c")):
        kernels._count("point_add", lanes, (tag,))
    assert kernels.LAUNCHES["point_add"] == 3
    assert kernels.LANES["point_add"] == 15
    assert kernels.WIDEST == {"point_add": (9, ("b",))}
    kernels.reset_launches()
    kernels._count("mont_mul", 5, ("d",))
    assert kernels.WIDEST == {} and kernels.LANES["point_add"] == 0
    kernels.reset_launches()


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3h2v16point_add_kernelINS_6Limbs8EEEvPKNT_1TES5_S5_jS5_S5_S5_jPKiS7_PKhPS3_SB_SB_j' for 'sm_90a'
ptxas info    : Function properties for _ZN3h2v16point_add_kernelINS_6Limbs8EEEv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mont_mul_kernelILi1EEEvPKiS2_Pij' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers
"""
SASS_TEXT = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115mont_mul_kernelILi1EEEvPKiS2_Pij
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
                                                                /* 0x000fe40000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R0, 0x4, R2 ;
        /*0020*/              @!P0 IADD3.X R3, P1, R4, R5, RZ, P0, !PT ;
        /*0030*/                   IMAD.MOV.U32 R6, RZ, RZ, R7 ;
        /*0040*/                   NOP ;
        /*0050*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_121sqrt_principal_kernelEPKiPij
        /*0000*/                   LDG.E R1, desc[UR4][R2.64] ;
        /*0010*/               @UP0 PRMT R1, R2, 0x5410, R3 ;
"""


def test_build_report_parsers():
    """What chip_smoke.py's build line reads: ptxas' registers and spill
    bytes, and the SASS counts of cuobjdump -sass, by readable kernel
    name."""
    assert kernels.kernel_label(
        "_ZN12_GLOBAL__N_116mont_mul8_kernelILi0EEEvPKfS2_Pfj") == (
            "mont_mul8_kernel<0>")
    # an anonymous namespace named after its file, with digits of its own
    assert kernels.kernel_label(
        "_ZN39_GLOBAL__N__40dd78b_8_tower_cu_bff71b4a13fq_inv_kernelILi1ELi3"
        "EEEvPKiPij") == "fq_inv_kernel<1>"
    assert kernels.ptxas_report(PTXAS_LOG) == {
        "point_add_kernel<Limbs8>": {"registers": 128, "spill_bytes": 12},
        "mont_mul_kernel<1>": {"registers": 32, "spill_bytes": 0}}
    sass = kernels.parse_sass(SASS_TEXT)
    mm = sass["mont_mul_kernel<1>"]
    assert (mm["sass"], mm["IMAD"], mm["IADD3"], mm["MOV"]) == (5, 1, 1, 1)
    sq = sass["sqrt_principal_kernel"]
    assert (sq["sass"], sq["LDG"], sq["PRMT"], sq["IMAD"]) == (2, 1, 1, 0)
