"""Loader for the native (C++) host runtime: transcript hashing, the replay
VM, the forest planner, the host MSM and the pairing.

The package keeps its own copy of the C++ sources (`native/` beside this
file) and builds them at first use into `_build/libh2vnative.so` with the
compiler flags of the repository's `native/Makefile`. The library is
optional: every consumer keeps a pure-Python fallback, so a missing
compiler only costs speed, never correctness.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libh2vnative.so")
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread"]

_lib = None
_load_attempted = False


def _sources():
    return sorted(
        os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR)
        if f.endswith(".cpp")
    )


def build(quiet: bool = True) -> bool:
    """Compile the native library into _build/; returns True on success.
    Writes a per-process temporary and renames it into place, so parallel
    test workers never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run(
            [cxx, *_CXXFLAGS, "-shared", "-o", tmp, *_sources()],
            check=True,
            capture_output=quiet,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def load():
    """Returns the ctypes library handle or None. Builds on first use if the
    source tree and a compiler are present."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    newest = max(
        os.path.getmtime(s)
        for s in _sources() + [os.path.join(_SRC_DIR, "bn254_core.h")]
    )

    def stale():
        return (not os.path.exists(_LIB_PATH)
                or newest > os.path.getmtime(_LIB_PATH))

    if stale():
        # one process builds, concurrent ones (test workers) wait for it
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(os.path.join(_BUILD_DIR, "native.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if stale() and not build() and not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.h2v_keccak_f1600.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    lib.h2v_keccak_f1600.restype = None
    lib.h2v_keccak_absorb_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.h2v_keccak_absorb_blocks.restype = None
    lib.h2v_keccak256_finalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    lib.h2v_keccak256_finalize.restype = None
    lib.h2v_modexp_batch.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.h2v_modexp_batch.restype = ctypes.c_uint64
    lib.h2v_inv_batch.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.h2v_inv_batch.restype = None
    lib.h2v_g1_decompress_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.h2v_g1_decompress_batch.restype = ctypes.c_uint64
    lib.h2v_g1_msm.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.h2v_g1_msm.restype = None
    lib.h2v_g1_mul.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.h2v_g1_mul.restype = None
    lib.h2v_pairing_check.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    lib.h2v_pairing_check.restype = ctypes.c_int
    lib.h2v_replay_batch.argtypes = [
        ctypes.c_char_p,                     # program
        ctypes.c_char_p,                     # proofs
        ctypes.c_uint64,                     # proof_stride
        ctypes.POINTER(ctypes.c_uint64),     # proof_lens
        ctypes.c_char_p,                     # aux
        ctypes.c_uint64,                     # aux_stride
        ctypes.c_uint64,                     # n_proofs
        ctypes.c_char_p,                     # weights (or None)
        ctypes.c_char_p,                     # out_scalars
        ctypes.c_char_p,                     # out_points
        ctypes.c_char_p,                     # status
        ctypes.c_int,                        # n_threads
        ctypes.c_char_p,                     # ext_y (or None): device-
                                             # decompressed principal roots
        ctypes.POINTER(ctypes.c_uint64),     # timings (or None): ns of the
                                             # sampled proofs' op classes
    ]
    lib.h2v_replay_batch.restype = ctypes.c_int64
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.h2v_forest_plan.argtypes = [
        u32p,                # scalars (total,16) canonical limbs
        ctypes.c_uint64,     # total
        u64p,                # sizes
        ctypes.c_uint64,     # n_groups
        ctypes.c_uint32,     # quant
        ctypes.c_uint32,     # fin_quant
        ctypes.c_uint32,     # floor
        ctypes.c_uint32,     # window_lo
        ctypes.c_uint32,     # window_count
        i32p, ctypes.c_uint64,   # point_idx0, cap
        i32p, ctypes.c_uint64,   # levels_buf, cap
        u64p, ctypes.c_uint64,   # level_widths, max_levels
        i32p, i32p, ctypes.c_uint64,  # fin_pos, fin_keys, cap
        u64p, ctypes.c_uint64,   # fin_meta, max_parts
        u64p,                # header[6]
    ]
    lib.h2v_forest_plan.restype = ctypes.c_int64
    _lib = lib
    return _lib
