"""Native batched replay: per-vk traced programs executed by the C++ VM.

CompiledReplay = trace once (protocol/trace.py) + execute per proof batch
(native/replayvm.cpp, threaded). Produces the same DualMSM entry lists as
protocol/verifier.verify_proof with a _Capture strategy — the Python path
remains the reference implementation; differential tests assert bit
equality (tests/test_replay_vm.py).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from ..ops.constants import R
from ..utils.metrics import maybe_stage
from .kzg import DualMSM, MSMKZG, VerifyFailure
from .trace import trace_verify


# the VM's op classes, in the order of h2v_replay_batch's timings buffer
OP_CLASS_STAGES = ("replay_vm_hash", "replay_vm_point", "replay_vm_field")


class MalformedProof(VerifyFailure):
    """The VM rejected a proof stream (bad encoding / truncation)."""

    def __init__(self, indices):
        super().__init__(f"malformed proofs at batch indices {indices}")
        self.indices = indices


def _load_vm():
    from .. import native

    lib = native.load()
    if lib is None or not hasattr(lib, "h2v_replay_batch"):
        return None
    return lib


class CompiledReplay:
    """One traced verifier program for (params, vk, instance shape,
    multiopen, hash)."""

    def __init__(self, params, vk, instance_shape, multiopen="shplonk",
                 hash_name="blake2b"):
        self.params = params
        # retain the vk: program caches key on its content digest, and
        # pinning the object also keeps id(vk)-based callers safe from
        # CPython id reuse after a caller drops its reference
        self.vk = vk
        self.program = trace_verify(params, vk, instance_shape,
                                    multiopen=multiopen,
                                    hash_name=hash_name)
        self.blob = self.program.serialize()
        self.n_out = len(self.program.out_regs)
        self.n_points = self.program.n_points
        self.n_aux = self.program.n_aux

    def replay_batch_raw(self, proofs_and_instances, weights=None,
                         ext_y=None, timings=None):
        """Run the VM; returns (scalars_bytes, points_bytes) raw buffers:
        scalars n * n_out * 32B canonical LE (weighted by the per-proof
        isolation weight when `weights` is given), points n * n_points *
        64B canonical LE x||y.

        ext_y: optional n*n_points*32B canonical LE principal roots of
        x^3+3 from the device sqrt pre-pass (ops/decomp.py) — the VM
        then checks y^2 == x^3+3 (~5 muls) instead of computing the
        ~381-mul Fermat sqrt per point.

        timings: an optional utils.metrics.StageTimings whose stage
        `replay_vm` times the native call alone; the staging of the
        inputs and the copies of the outputs around it are the caller's.
        The VM then also times one proof in every 8 by op class, and the
        call's wall time is split by those shares into the stages
        OP_CLASS_STAGES (the Fiat-Shamir hash, the point decoding and
        curve checks, the field arithmetic), laid end to end inside
        `replay_vm`, on its thread: apportioned, not observed intervals.
        Without timings the VM reads no clock; the outputs are the same
        either way.

        Raises MalformedProof (listing indices) if any proof stream is
        invalid — the same outcome class as the Python replay raising on
        the first bad proof.
        """
        lib = _load_vm()
        assert lib is not None, "native VM unavailable"
        n = len(proofs_and_instances)
        stride = max(len(p) for p, _ in proofs_and_instances)
        stride = max(stride, 1)
        proof_buf = bytearray(n * stride)
        lens = np.empty(n, dtype=np.uint64)
        aux_stride = self.n_aux * 32
        aux_buf = bytearray(max(n * aux_stride, 1))
        for i, (proof, instances) in enumerate(proofs_and_instances):
            proof_buf[i * stride: i * stride + len(proof)] = proof
            lens[i] = len(proof)
            flat = [v for col in instances for v in col]
            if len(flat) != self.n_aux:
                raise ValueError("instance shape mismatch vs traced program")
            off = i * aux_stride
            for v in flat:
                aux_buf[off: off + 32] = int(v % R).to_bytes(32, "little")
                off += 32
        wbuf = None
        if weights is not None:
            assert len(weights) == n
            wbuf = b"".join(int(w % R).to_bytes(32, "little")
                            for w in weights)

        out_scalars = ctypes.create_string_buffer(n * self.n_out * 32)
        out_points = ctypes.create_string_buffer(
            max(n * self.n_points * 64, 1))
        status = ctypes.create_string_buffer(n)
        # pass the staging bytearrays without copying (MBs per batch)
        proof_c = ctypes.cast(
            (ctypes.c_char * len(proof_buf)).from_buffer(proof_buf),
            ctypes.c_char_p)
        aux_c = ctypes.cast(
            (ctypes.c_char * len(aux_buf)).from_buffer(aux_buf),
            ctypes.c_char_p)
        class_ns = None if timings is None else (ctypes.c_uint64 * 4)()
        with maybe_stage(timings, "replay_vm"):
            t0 = time.perf_counter()
            bad = lib.h2v_replay_batch(
                bytes(self.blob), proof_c, stride,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                aux_c, aux_stride, n, wbuf, out_scalars, out_points,
                status, 2, ext_y, class_ns,
            )
            if class_ns is not None and class_ns[3]:
                # apportioned, not observed: the classes alternate along
                # the tape, so their parts are laid end to end in the call
                wall = time.perf_counter() - t0
                done = 0
                for k, name in enumerate(OP_CLASS_STAGES):
                    a = t0 + wall * done / class_ns[3]
                    done += class_ns[k]
                    timings.add_span(name, a,
                                     t0 + wall * done / class_ns[3])
        if bad < 0:
            raise RuntimeError("replay VM rejected the program")
        if bad:
            raise MalformedProof(
                [i for i in range(n) if status.raw[i]]
            )
        return out_scalars.raw, out_points.raw

    def gather_point_xs(self, proofs):
        """Gather every proof point's compressed x coordinate (sign bit
        masked) as (n * n_points, 16) uint32 canonical LE limbs — the
        device sqrt pre-pass input (ops/decomp.py). Point byte
        offsets are vk-static (program.point_offsets); short proofs pad
        with zeros (the VM rejects them independently)."""
        offs = np.asarray(self.program.point_offsets, dtype=np.int64)
        npts = offs.shape[0]
        n = len(proofs)
        length = len(proofs[0]) if proofs else 0
        if (n and npts and all(len(p) == length for p in proofs)
                and int(offs.max()) + 32 <= length):
            mat = np.frombuffer(b"".join(proofs), dtype=np.uint8)
            mat = mat.reshape(n, length)
            out = np.ascontiguousarray(
                mat[:, offs[:, None] + np.arange(32)[None, :]]
            ).reshape(n * npts, 32)
        else:  # ragged / short proofs: per-proof slices, zero padding
            out = np.zeros((n * npts, 32), dtype=np.uint8)
            for i, p in enumerate(proofs):
                pv = np.frombuffer(p, dtype=np.uint8)
                row = i * npts
                for j, off in enumerate(offs):
                    if off + 32 <= pv.shape[0]:
                        out[row + j] = pv[off:off + 32]
        out[:, 31] &= 0x7F
        return out.view("<u2").astype(np.uint32)

    @staticmethod
    def pack_ext_y(y_limbs, count):
        """Device sqrt output (16, B) uint32 canonical 16-bit limbs ->
        count*32B LE bytes for replay_batch_raw(ext_y=...)."""
        return np.ascontiguousarray(
            y_limbs[:, :count].T.astype(np.uint16)
        ).tobytes()

    # ------------------------------------------------- batch-array fast path

    def _entry_plan(self):
        """Static per-program entry layout: proof-point entries as gather
        index arrays, vk-constant bases grouped for cross-batch scalar
        summation (every proof contributes a term on the same base)."""
        if hasattr(self, "_plan"):
            return self._plan
        plan = {}
        for side in ("left", "right"):
            entries = getattr(self.program, f"{side}_entries")
            pt_out, pt_ref = [], []
            const_groups = {}
            for out_idx, (kind, ref) in entries:
                if kind == "pt":
                    pt_out.append(out_idx)
                    pt_ref.append(ref)
                else:
                    const_groups.setdefault(ref, []).append(out_idx)
            plan[side] = (
                np.asarray(pt_out, dtype=np.int64),
                np.asarray(pt_ref, dtype=np.int64),
                list(const_groups.items()),
            )
        self._plan = plan
        return plan

    @staticmethod
    def _col_sum_mod_r(scal16, out_idxs):
        """Sum the given scalar columns over the whole batch, exactly:
        u64 limb-wise sums (n * 65535 << 2^64) finished in Python ints."""
        total = 0
        for oi in out_idxs:
            limbs = scal16[:, oi, :].astype(np.uint64).sum(axis=0)
            v = 0
            for k in range(15, -1, -1):
                v = (v << 16) + int(limbs[k])
            total += v
        return total % R

    def batch_msm_arrays(self, sc_raw, pt_raw, n):
        """Raw VM outputs -> per-side canonical limb arrays for the batch
        accumulator MSMs: {'left'|'right': (S, X, Y)} with S/X/Y
        (entries, 16) uint32 — scalars already carry the per-proof weights
        (replay_batch_raw(weights=...)), vk-shared bases pre-summed to one
        entry each. No per-entry Python big-int work."""
        scal16 = np.frombuffer(sc_raw, dtype="<u2").reshape(
            n, self.n_out, 16)
        pts16 = np.frombuffer(pt_raw, dtype="<u2").reshape(
            n, max(self.n_points, 1), 32)
        out = {}
        for side, (pt_out, pt_ref, const_groups) in \
                self._entry_plan().items():
            S = scal16[:, pt_out, :].reshape(-1, 16).astype(np.uint32)
            X = pts16[:, pt_ref, :16].reshape(-1, 16).astype(np.uint32)
            Y = pts16[:, pt_ref, 16:].reshape(-1, 16).astype(np.uint32)
            if const_groups:
                cs, cx, cy = [], [], []
                for base, out_idxs in const_groups:
                    cs.append(self._col_sum_mod_r(scal16, out_idxs))
                    cx.append(0 if base is None else base[0])
                    cy.append(0 if base is None else base[1])
                from ..ops.limbs import ints_to_limbs

                S = np.concatenate([S, ints_to_limbs(cs)])
                X = np.concatenate([X, ints_to_limbs(cx)])
                Y = np.concatenate([Y, ints_to_limbs(cy)])
            out[side] = (S, X, Y)
        return out

    def replay_batch(self, proofs_and_instances, timings=None):
        """[(proof_bytes, instances)] -> list of DualMSM (exact parity with
        the Python replay's accumulators). timings: as replay_batch_raw's."""
        sc, pt = self.replay_batch_raw(proofs_and_instances, timings=timings)
        n = len(proofs_and_instances)
        duals = []
        for i in range(n):
            so = i * self.n_out * 32
            scalars = [
                int.from_bytes(sc[so + 32 * j: so + 32 * (j + 1)], "little")
                for j in range(self.n_out)
            ]
            po = i * self.n_points * 64
            points = [
                (
                    int.from_bytes(pt[po + 64 * j: po + 64 * j + 32],
                                   "little"),
                    int.from_bytes(pt[po + 64 * j + 32: po + 64 * (j + 1)],
                                   "little"),
                )
                for j in range(self.n_points)
            ]

            def build(entries):
                m = MSMKZG()
                for out_idx, (kind, ref) in entries:
                    base = points[ref] if kind == "pt" else ref
                    m.append_term(scalars[out_idx], base)
                return m

            duals.append(DualMSM(
                self.params,
                build(self.program.left_entries),
                build(self.program.right_entries),
            ))
        return duals


def vm_available() -> bool:
    return _load_vm() is not None
