"""Build, bind and launch the package's Hopper kernels (csrc/*.cu).

Each CUDA source compiles with nvcc into its own shared library with a
plain C interface (sm_90a, -O3), loaded with ctypes: seconds per build,
where a build that includes PyTorch's headers takes minutes. The build runs
at first use, every source's nvcc started together, into `_build/` (keyed
by a hash of the sources, so an edited source rebuilds). Nothing here runs
at import: this module imports on machines without nvcc or a card.

Every C entry launches on the caller's stream and returns
cudaGetLastError(); the wrappers raise on a nonzero code. A wrapper adds
one to its launch counter where it launches its kernel, and nowhere else;
after reset_launches(record=True) it also keeps the arguments of its
widest launch, so a caller can rerun exactly that launch. Under a CUDA
graph capture on the calling thread (recorded_launches) a wrapper records
its kernel instead, and count_replay counts the launches of each replay.
There is no fallback: a wrapper given CPU tensors raises (the plain
versions live beside the callers, in ops/field.py, ops/field8.py,
ops/curve.py, ops/decomp.py, ops/msm_forest.py and ops/pairing.py).

Two limb formats cross this boundary: (16, B) int32 rows of 16-bit limbs
and (32, B) float32 rows of 8-bit limbs. The float32 kernels take
canonical limbs, integers in [0, 255], and do not pay for a check. The
kernels address rows in 32 bits, so every tensor they read or write has
fewer than 2^31 elements (the wrappers raise otherwise).

`build_report()` states what each built kernel issues: ptxas' registers
and spill bytes, and from `cuobjdump -sass` the kernel's static SASS
instruction count with the counts of the classes that explain its bound.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

from .limbs import NLIMBS

NLIMBS8 = 32
# limb format -> (rows, dtype)
FORMATS = {"u16": (NLIMBS, torch.int32), "f8": (NLIMBS8, torch.float32)}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("mont_mul.cu", "frontier.cu", "point_add.cu", "point_double.cu",
           "mont_mul8.cu", "point_add8.cu", "tower.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_ELEMENTS = 1 << 31  # rows are addressed in 32 bits
# SASS opcode classes counted by sass_report (by opcode stem: IMAD covers
# IMAD.WIDE, IMAD.HI, IMAD.X; MOV counts MOV and IMAD.MOV, register moves)
SASS_CLASSES = ("IMAD", "IADD3", "LOP3", "PRMT", "SEL", "F2I", "I2F",
                "FFMA", "FADD", "LDG", "STG", "MOV")

_lock = threading.Lock()
_build_lock = threading.Lock()
_libs: dict = {}

# launches and output lanes per kernel since the last reset_launches();
# point_add_narrow: those of point_add (either K2 entry) that took the
# narrow shape, a part of point_add's count and not a kernel of its own
LAUNCHES = {"mont_mul": 0, "sqrt_principal": 0, "forest_frontier0": 0,
            "point_add": 0, "point_double": 0, "mont_mul8": 0,
            "point_add8": 0, "fq_addsub": 0, "fq12_mul": 0,
            "fq_inv": 0, "miller_step": 0, "point_add_narrow": 0}
LANES = dict.fromkeys(LAUNCHES, 0)
# the counters that count a part of another kernel's launches
PART_COUNTERS = ("point_add_narrow",)
# while recording: kernel -> (output lanes, args) of its widest launch
WIDEST: dict = {}
_recording = False
_capture = threading.local()  # .tally while a graph captures on the thread


def reset_launches(record: bool = False) -> None:
    """Zero the counters; with record=True, also keep each kernel's widest
    launch in WIDEST until the next reset (this holds its input tensors)."""
    global _recording
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            LANES[k] = 0
        WIDEST.clear()
        _recording = record


def _count(name: str, lanes: int, args: tuple) -> None:
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        # a CUDA graph is capturing on this thread: the kernel was
        # recorded, not launched; count_replay counts each replay of it
        n, total = tally.get(name, (0, 0))
        tally[name] = (n + 1, total + lanes)
        return
    with _lock:
        LAUNCHES[name] += 1
        LANES[name] += lanes
        if _recording and lanes > WIDEST.get(name, (0,))[0]:
            WIDEST[name] = (lanes, args)


@contextlib.contextmanager
def recorded_launches():
    """While a CUDA graph captures on this thread, the wrappers record
    their kernels into it instead of launching them: this tallies those
    launches, {kernel: (launches, lanes)}, in place of the counters."""
    tally = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def count_replay(tally: dict) -> None:
    """Count the launches one replay of a recorded graph makes (its
    recorded_launches tally): a replay launches every kernel it holds."""
    with _lock:
        for name, (n, lanes) in tally.items():
            LAUNCHES[name] += n
            LANES[name] += lanes


def _cuda_tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA toolkit is missing")
    return path


def _digest(csrc_dir: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(csrc_dir)):
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:12]


def build(csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR,
          sources=SOURCES) -> dict:
    """Compile each of `sources` in csrc_dir into build_dir (one nvcc
    each, all started together) unless this source hash is built already;
    returns {source: (library path, nvcc/ptxas log)}, the log kept beside
    each library. Raises if any build fails."""
    os.makedirs(build_dir, exist_ok=True)
    tag = _digest(csrc_dir)
    nvcc = _cuda_tool("nvcc")
    procs = {}
    for src in sources:
        so = _so_path(build_dir, src, tag)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[src] = (so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(csrc_dir, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (so, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        with open(so[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    built = {}
    for src in sources:
        so = _so_path(build_dir, src, tag)
        with open(so[:-3] + ".log") as f:
            built[src] = (so, f.read())
    return built


def _so_path(build_dir: str, src: str, tag: str) -> str:
    return os.path.join(build_dir, f"{src[:-3]}.{tag}.so")


def kernel_label(mangled: str) -> str:
    """A readable name for a kernel's mangled symbol, e.g.
    point_add_kernel<Limbs16>, mont_mul_kernel<0>,
    narrow::point_add_kernel<Limbs16> (a namespace inside h2v is kept).
    Every digit run is read as a length-prefixed name; the shortest such
    name that ends in _kernel is the kernel's (a longer one spans a digit
    inside an anonymous namespace's own name, such as
    _GLOBAL__N__40dd78b_...)."""
    names = [mangled[i + len(m.group()):i + len(m.group()) + int(m.group())]
             for i in range(len(mangled))
             if (m := re.match(r"\d+", mangled[i:]))]
    name = min((n for n in names if n.endswith("_kernel")), key=len,
               default=None)
    if name is None:
        return mangled
    arg = (re.search(r"_kernelILi(\d+)E", mangled)
           or re.search(r"(Limbs\d+)", mangled))
    inner = re.match(r"_ZN3h2v(\d+)", mangled)
    if inner:
        ns = mangled[inner.end():inner.end() + int(inner.group(1))]
        if ns != name:
            name = f"{ns}::{name}"
    return name + (f"<{arg.group(1)}>" if arg else "")


def ptxas_report(log: str) -> dict:
    """{kernel label: {"registers", "spill_bytes"}} from `nvcc -Xptxas -v`
    output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)),
                                 {"registers": None, "spill_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def sass_report(so: str) -> dict:
    """parse_sass of `cuobjdump -sass` on a built library. Raises if
    cuobjdump is missing or fails."""
    return parse_sass(subprocess.run(
        [_cuda_tool("cuobjdump"), "-sass", so], capture_output=True,
        text=True, check=True, timeout=300).stdout)


def parse_sass(text: str) -> dict:
    """{kernel label: {"sass": static instruction count (NOPs left out),
    class: count for each of SASS_CLASSES}} from `cuobjdump -sass`
    output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)),
                                 {"sass": 0, **dict.fromkeys(SASS_CLASSES, 0)})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m is None or cur is None:
            continue
        op = m.group(1)
        stem = "MOV" if op.startswith("IMAD.MOV") else op.split(".")[0]
        if stem == "NOP":
            continue
        cur["sass"] += 1
        if stem in cur:
            cur[stem] += 1
    return out


def build_report(csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR,
                 sources=SOURCES) -> dict:
    """build(), then {source: {kernel label: ptxas' registers and spill
    bytes, SASS counts}} for every source."""
    report = {}
    for src, (so, log) in build(csrc_dir, build_dir, sources).items():
        ptx = ptxas_report(log)
        for label, counts in sass_report(so).items():
            report.setdefault(src, {})[label] = {**ptx.get(label, {}),
                                                 **counts}
    return report


def _lib(src: str):
    with _build_lock:
        lib = _libs.get(src)
        if lib is None:
            lib = _load(src)
            _libs[src] = lib
    return lib


_VP, _LL, _CI = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_POINT_ADD_ARGS = ([_VP, _VP, _VP, _LL] * 2 + [_VP, _VP, _VP]
                   + [_VP, _VP, _VP, _LL, _VP])
# source -> {C entry: argument types}; every entry returns an int
SIGNATURES = {
    "mont_mul.cu": {
        "h2v_mont_mul": [_VP, _VP, _VP, _LL, _CI, _VP],
        "h2v_sqrt_principal": [_VP, _VP, _LL, _VP],
        "h2v_sqrt_principal_beside": [_VP, _VP, _LL, _VP, _VP, _VP, _LL,
                                      _VP, _VP],
    },
    "frontier.cu": {
        "h2v_forest_frontier0": [_VP, _VP, _LL, _VP] + [_VP] * 3
        + [_LL, _VP, _VP],
    },
    "point_add.cu": {
        "h2v_point_add": _POINT_ADD_ARGS,
        "h2v_point_add_scatter": [_VP, _VP, _VP, _LL, _VP, _VP]
        + [_VP, _VP, _VP, _LL] + [_VP, _VP, _LL] + [_VP, _VP, _VP, _LL, _VP],
        "h2v_capture_nodes": [_VP, _VP],
        "h2v_point_add_narrow_below": [],
    },
    "point_double.cu": {"h2v_point_double": [_VP] * 6 + [_LL, _VP]},
    "mont_mul8.cu": {"h2v_mont_mul8": [_VP, _VP, _VP, _LL, _CI, _VP]},
    "point_add8.cu": {"h2v_point_add8": _POINT_ADD_ARGS},
    "tower.cu": {
        "h2v_fq_addsub": [_VP, _LL, _VP, _LL, _VP, _LL, _CI, _VP],
        "h2v_fq12_mul": [_VP, _VP, _VP, _LL, _VP],
        "h2v_fq_inv": [_VP, _VP, _LL, _CI, _VP],
        "h2v_miller_step": [_VP, _VP, _VP, _LL, _VP, _LL, _VP, _VP, _LL,
                            _CI, _VP],
    },
}


def bind(so: str, src: str):
    """A built library of `src`, its C entries typed by SIGNATURES."""
    lib = ctypes.CDLL(so)
    for entry, argtypes in SIGNATURES[src].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = _CI
    return lib


def _load(src: str):
    return bind(build()[src][0], src)


def _check_limbs(name, fmt, *ts):
    rows, dtype = FORMATS[fmt]
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: expects CUDA tensors on one device")
        if t.dtype != dtype or t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name}: expects ({rows}, B) {dtype} limbs, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous limbs")
        if t.numel() >= MAX_ELEMENTS:
            raise ValueError(f"{name}: a tensor of 2^31 or more elements")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _mont_mul(name, fmt, src, a, b, field_id):
    _check_limbs(name, fmt, a, b)
    if a.shape != b.shape:
        raise ValueError(f"{name}: operand shapes differ")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    entry = getattr(_lib(src), f"h2v_{name}")
    with torch.cuda.device(a.device):
        rc = entry(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1],
                   field_id, _stream(a.device))
    _raise_on(rc, name)
    _count(name, a.shape[1], (a, b, field_id))
    return out


def mont_mul(a, b, field_id: int):
    """K1: Montgomery product of (16, B) int32 limb tensors on the card,
    canonical output. field_id 0 = Fq, 1 = Fr."""
    return _mont_mul("mont_mul", "u16", "mont_mul.cu", a, b, field_id)


def mont_mul8(a, b, field_id: int):
    """K4: Montgomery product of (32, B) float32 tensors of canonical
    8-bit limbs on the card, canonical output. field_id 0 = Fq, 1 = Fr."""
    return _mont_mul("mont_mul8", "f8", "mont_mul8.cu", a, b, field_id)


class HostCopy(NamedTuple):
    """An H2D copy to queue: pinned `src` into `dst` on the card, on
    `stream`, with the event `done` recorded after it (an event that has
    been recorded once, so that it has its CUDA handle)."""
    dst: torch.Tensor
    src: torch.Tensor
    stream: torch.cuda.Stream
    done: torch.cuda.Event


def host_copy(c: HostCopy) -> None:
    """Queue `c` on its own."""
    with torch.cuda.stream(c.stream):
        c.dst.copy_(c.src, non_blocking=True)
        c.done.record(c.stream)


def sqrt_principal(xs, beside=None):
    """The decomp pre-pass's square root: (16, B) canonical x limbs ->
    canonical principal roots y0 = (x^3 + 3)^((q+1)/4) in one launch.
    beside: a HostCopy queued by the same native call right after the
    launch, so that it runs beside the kernel whatever holds the host."""
    _check_limbs("sqrt_principal", "u16", xs)
    out = torch.empty_like(xs)
    if out.numel() == 0:
        if beside is not None:
            host_copy(beside)
        return out
    lib = _lib("mont_mul.cu")
    with torch.cuda.device(xs.device):
        if beside is None:
            rc = lib.h2v_sqrt_principal(xs.data_ptr(), out.data_ptr(),
                                        xs.shape[1], _stream(xs.device))
        else:
            c = beside
            if (not c.src.is_pinned() or c.dst.device != xs.device
                    or c.src.dtype != c.dst.dtype
                    or c.src.numel() != c.dst.numel()
                    or not (c.src.is_contiguous()
                            and c.dst.is_contiguous())):
                raise ValueError("sqrt_principal: beside copies a pinned "
                                 "contiguous tensor into one of its shape "
                                 "and type on the roots' card")
            rc = lib.h2v_sqrt_principal_beside(
                xs.data_ptr(), out.data_ptr(), xs.shape[1],
                _stream(xs.device), c.dst.data_ptr(), c.src.data_ptr(),
                c.src.numel() * c.src.element_size(), c.stream.cuda_stream,
                c.done.cuda_event)
    _raise_on(rc, "sqrt_principal")
    _count("sqrt_principal", xs.shape[1], (xs,))
    return out


def forest_frontier0(xs, ys, idx):
    """The forest's level-0 frontier: (16, n) canonical affine limbs xs,
    ys and a (w0,) int32 index into their lanes (in range: the caller's
    contract, the forest validates its plan on the host) -> the
    projective Montgomery points of the indexed lanes, (0, 0) lanes as
    the identity. Returns a (X, Y, Z) tuple of (16, w0) views into one
    (3, 16, w0) tensor."""
    _check_limbs("forest_frontier0", "u16", xs, ys)
    n = xs.shape[1]
    if ys.shape[1] != n:
        raise ValueError("forest_frontier0: xs and ys widths differ")
    if (idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != xs.device
            or not idx.is_contiguous()):
        raise ValueError("forest_frontier0: idx must be a contiguous 1-D "
                         "int32 tensor on the card")
    w0 = idx.shape[0]
    if NLIMBS * w0 >= MAX_ELEMENTS:
        raise ValueError("forest_frontier0: an output of 2^31 or more "
                         "elements")
    out = torch.empty((3, NLIMBS, w0), dtype=torch.int32, device=xs.device)
    if w0 == 0:
        return out[0], out[1], out[2]
    # the kernel's point-major copy of the converted points, 64 B each
    scratch = torch.empty((n, NLIMBS), dtype=torch.int32, device=xs.device)
    lib = _lib("frontier.cu")
    with torch.cuda.device(xs.device):
        rc = lib.h2v_forest_frontier0(
            xs.data_ptr(), ys.data_ptr(), n, idx.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), w0,
            scratch.data_ptr(), _stream(xs.device))
    _raise_on(rc, "forest_frontier0")
    _count("forest_frontier0", w0, (xs, ys, idx))
    return out[0], out[1], out[2]


def point_double(p):
    """K3: out[i] = 2 * P[i] with the complete RCB15 doubling. p: (X, Y, Z)
    tuple of (16, B) int32 Montgomery limbs. Returns a (X, Y, Z) tuple of
    (16, B) views into one (3, 16, B) tensor."""
    _check_limbs("point_double", "u16", *p)
    b = p[0].shape[1]
    if any(c.shape[1] != b for c in p):
        raise ValueError("point_double: coordinate widths differ")
    out = torch.empty((3, NLIMBS, b), dtype=torch.int32, device=p[0].device)
    if b == 0:
        return out[0], out[1], out[2]
    lib = _lib("point_double.cu")
    with torch.cuda.device(p[0].device):
        rc = lib.h2v_point_double(
            *(c.data_ptr() for c in p),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), b,
            _stream(p[0].device))
    _raise_on(rc, "point_double")
    _count("point_double", b, (p,))
    return out[0], out[1], out[2]


def _point_add(name, fmt, src, p, q, mask, iL, iR):
    args = (p, q, mask, iL, iR)
    rows, dtype = FORMATS[fmt]
    _check_limbs(name, fmt, *p, *q)
    wp, wq = p[0].shape[1], q[0].shape[1]
    if any(c.shape[1] != wp for c in p) or any(c.shape[1] != wq for c in q):
        raise ValueError(f"{name}: coordinate widths differ")
    if iL is not None:
        b = iL.shape[0]
    elif iR is not None:
        b = iR.shape[0]
    else:
        b = wp
    for side, idx, w in (("iL", iL, wp), ("iR", iR, wq)):
        if idx is None:
            if b != w:
                raise ValueError(f"{name}: no {side} and width {w} != {b}")
            continue
        if (idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] != b
                or idx.device != p[0].device or not idx.is_contiguous()):
            raise ValueError(f"{name}: {side} must be a contiguous "
                             f"({b},) int32 tensor on the card")
    if mask is not None:
        if mask.dtype == torch.bool:
            mask = mask.view(torch.uint8)
        if (mask.dtype != torch.uint8 or mask.shape != (b,)
                or mask.device != p[0].device):
            raise ValueError(f"{name}: mask must be ({b},) uint8/bool")
        mask = mask.contiguous()
    if rows * b >= MAX_ELEMENTS:
        raise ValueError(f"{name}: an output of 2^31 or more elements")
    out = torch.empty((3, rows, b), dtype=dtype, device=p[0].device)
    if b == 0:
        return out[0], out[1], out[2]
    entry = getattr(_lib(src), f"h2v_{name}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(p[0].device):
        rc = entry(
            *(c.data_ptr() for c in p), wp, *(c.data_ptr() for c in q), wq,
            ptr(iL), ptr(iR), ptr(mask),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), b,
            _stream(p[0].device))
    _raise_on(rc, name)
    if name == "point_add":
        _count_point_add(b, args)
    else:
        _count(name, b, args)
    return out[0], out[1], out[2]


def narrow_below() -> int:
    """The add lanes below which a K2 launch takes the narrow shape
    (csrc/point.cuh NarrowShape, the launcher's one rule)."""
    return _lib("point_add.cu").h2v_point_add_narrow_below()


def _count_point_add(lanes: int, args: tuple) -> None:
    """Count a K2 launch of `lanes` add lanes, and in point_add_narrow
    too where it took the narrow shape."""
    _count("point_add", lanes, args)
    if lanes < narrow_below():
        _count("point_add_narrow", lanes, args)


def point_add(p, q, mask=None, iL=None, iR=None):
    """K2: out[i] = mask[i] ? P[i] + Q[i] : P[i] with the complete RCB15
    add, P[i] = p[:, iL[i]] (or p[:, i]) and Q[i] = q[:, iR[i]] (or
    q[:, i]). p, q: (X, Y, Z) tuples of (16, W) int32 Montgomery limbs;
    iL/iR: int32 index tensors, in range (the caller's contract: the
    forest validates its plan on the host); mask: bool or uint8. The
    output is a new tensor, so p or q may be read at any lane.
    Returns a (X, Y, Z) tuple of (16, B) views into one (3, 16, B)
    tensor."""
    return _point_add("point_add", "u16", "point_add.cu", p, q, mask, iL, iR)


def point_add_scatter(f, iL, iR, pos, keys, grid):
    """K2 with scatter lanes, one launch: a forest level's adds out[i] =
    f[:, iL[i]] + f[:, iR[i]] (iL, iR None: no add lanes) and its
    finished part written into the bucket grid, grid[:, keys[j]] =
    f[:, pos[j]] with Y := R mod q where Y = Z = 0. f: (X, Y, Z) tuple of
    (16, W) int32 Montgomery limbs; grid: (X, Y, Z) tuple of (16, G) int32
    rows on the same card, written in place; iL, iR, pos, keys: int32
    indices, in range (the caller's contract: the forest validates its
    plan, keys included, on the host). Returns the level's (X, Y, Z), (16,
    B) views into one (3, 16, B) tensor (B = 0 without add lanes). Counted
    as a point_add launch of B lanes, the add alone (the scatter lanes add
    nothing), with point_add's arguments for those lanes, and as a
    point_add_narrow one where B < narrow_below()."""
    name = "point_add_scatter"
    _check_limbs(name, "u16", *f, *grid)
    wf, wg = f[0].shape[1], grid[0].shape[1]
    if any(c.shape[1] != wf for c in f) or any(c.shape[1] != wg
                                               for c in grid):
        raise ValueError(f"{name}: coordinate widths differ")
    if (iL is None) != (iR is None):
        raise ValueError(f"{name}: iL and iR go together")
    b = 0 if iL is None else iL.shape[0]
    s = pos.shape[0]
    for side, idx, w in (("iL", iL, b), ("iR", iR, b), ("pos", pos, s),
                         ("keys", keys, s)):
        if idx is None:
            continue
        if (idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] != w
                or idx.device != f[0].device or not idx.is_contiguous()):
            raise ValueError(f"{name}: {side} must be a contiguous ({w},) "
                             "int32 tensor on the card")
    if NLIMBS * b >= MAX_ELEMENTS or b + s >= MAX_ELEMENTS:
        raise ValueError(f"{name}: 2^31 or more output elements or lanes")
    out = torch.empty((3, NLIMBS, b), dtype=torch.int32, device=f[0].device)
    if b + s == 0:
        return out[0], out[1], out[2]
    lib = _lib("point_add.cu")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(f[0].device):
        rc = lib.h2v_point_add_scatter(
            *(c.data_ptr() for c in f), wf, ptr(iL), ptr(iR),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), b,
            pos.data_ptr(), keys.data_ptr(), s,
            *(c.data_ptr() for c in grid), wg, _stream(f[0].device))
    _raise_on(rc, name)
    _count_point_add(b, (f, f, None, iL, iR))
    return out[0], out[1], out[2]


def capture_nodes(device) -> dict:
    """The nodes of the CUDA graph being captured on `device`'s current
    stream, by type: {"kernel", "memcpy", "memset", "other": count}.
    Raises if no capture runs there."""
    counts = (ctypes.c_longlong * 4)()
    lib = _lib("point_add.cu")
    with torch.cuda.device(device):
        rc = lib.h2v_capture_nodes(_stream(device), counts)
    _raise_on(rc, "capture_nodes")
    return dict(zip(("kernel", "memcpy", "memset", "other"), counts))


def point_add8(p, q, mask=None, iL=None, iR=None):
    """K5: point_add on (32, W) float32 tensors of canonical 8-bit limbs;
    returns (32, B) views into one (3, 32, B) float32 tensor."""
    return _point_add("point_add8", "f8", "point_add8.cu", p, q, mask, iL,
                      iR)


# T1's operations
FQ_ADD, FQ_SUB, FQ_NEG = 0, 1, 2


def _check_rows(name, *ts):
    """(16, B) int32 limb rows on one card, lanes at unit stride and rows
    at any stride (a column slice of a wider tensor), every element
    addressed in 32 bits."""
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: expects CUDA tensors on one device")
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != NLIMBS:
            raise ValueError(f"{name}: expects ({NLIMBS}, B) int32 limbs, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: expects lanes at unit stride")
        if t.stride(0) * (NLIMBS - 1) + t.shape[1] >= MAX_ELEMENTS:
            raise ValueError(f"{name}: rows past 32-bit addressing")


def fq_addsub(a, b, op: int):
    """T1: the elementwise Fq add (op FQ_ADD), subtract (FQ_SUB) or
    negate (FQ_NEG, b None) of (16, B) int32 canonical Montgomery limbs,
    each operand at its own row stride; a new contiguous output."""
    if op not in (FQ_ADD, FQ_SUB, FQ_NEG):
        raise ValueError(f"fq_addsub: unknown op {op}")
    ts = (a,) if op == FQ_NEG else (a, b)
    _check_rows("fq_addsub", *ts)
    if op != FQ_NEG and b.shape != a.shape:
        raise ValueError("fq_addsub: operand shapes differ")
    width = a.shape[1]
    out = torch.empty((NLIMBS, width), dtype=torch.int32, device=a.device)
    if width == 0:
        return out
    lib = _lib("tower.cu")
    with torch.cuda.device(a.device):
        rc = lib.h2v_fq_addsub(
            a.data_ptr(), a.stride(0),
            None if op == FQ_NEG else b.data_ptr(),
            0 if op == FQ_NEG else b.stride(0),
            out.data_ptr(), width, op, _stream(a.device))
    _raise_on(rc, "fq_addsub")
    _count("fq_addsub", width, (a, b, op))
    return out


FQ12_COEFS = 12  # an Fq12 element's Fq coefficients


def fq12_mul(a, b):
    """The Fq12 multiply in one launch: a, b (16, 12, B) int32 stacks of
    canonical Montgomery coefficients (limb, coefficient, lane), both
    contiguous on the card (b may be a, for a square); returns their
    product as a new (16, 12, B) stack, canonical."""
    dev = a.device
    for t in (a, b):
        if not t.is_cuda or t.device != dev:
            raise ValueError("fq12_mul: expects CUDA tensors on one device")
        if (t.dtype != torch.int32 or t.dim() != 3
                or t.shape[:2] != (NLIMBS, FQ12_COEFS)
                or not t.is_contiguous()):
            raise ValueError("fq12_mul: expects contiguous (16, 12, B) "
                             f"int32 stacks, got {tuple(t.shape)} {t.dtype}")
    if a.shape != b.shape:
        raise ValueError("fq12_mul: operand shapes differ")
    if a.numel() >= MAX_ELEMENTS:
        raise ValueError("fq12_mul: a tensor of 2^31 or more elements")
    out = torch.empty_like(a)
    width = a.shape[2]
    if width == 0:
        return out
    lib = _lib("tower.cu")
    with torch.cuda.device(dev):
        rc = lib.h2v_fq12_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              width, _stream(dev))
    _raise_on(rc, "fq12_mul")
    _count("fq12_mul", width, (a, b))
    return out


def fq_inv(a, field_id: int):
    """T3: the Fermat inversion a^(N-2) of (16, B) int32 canonical
    Montgomery limbs on the card (a R -> a^-1 R, inv(0) = 0). field_id
    0 = Fq, 1 = Fr."""
    _check_limbs("fq_inv", "u16", a)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    lib = _lib("tower.cu")
    with torch.cuda.device(a.device):
        rc = lib.h2v_fq_inv(a.data_ptr(), out.data_ptr(), a.shape[1],
                            field_id, _stream(a.device))
    _raise_on(rc, "fq_inv")
    _count("fq_inv", a.shape[1], (a, field_id))
    return out


# the Miller step's modes
MILLER_DOUBLE, MILLER_ADD = 0, 1
G2_COEFS = 4  # an affine G2 point's Fq coefficients (x0, x1, y0, y1)


def miller_step(mode: int, t, q, px, py):
    """One affine Miller step in one launch: mode MILLER_DOUBLE doubles T
    (the tangent at T), MILLER_ADD adds Q to T (the chord), and either
    evaluates the line at P = (px, py). t, q: contiguous (16, 4, B) int32
    stacks (x0, x1, y0, y1) of canonical Montgomery limbs on the card (q
    None when doubling); px, py: (16, B) limb rows, each at its own row
    stride. Returns (T', line): a new (16, 4, B) stack and the line's
    (16, 12, B) coefficient stack (py, c3 and c4 in their slots of
    ops/pairing.py _fq12_coeff_stack, zeros elsewhere)."""
    if mode not in (MILLER_DOUBLE, MILLER_ADD):
        raise ValueError(f"miller_step: unknown mode {mode}")
    dev = t.device
    stacks = (t,) if mode == MILLER_DOUBLE else (t, q)
    for s in stacks:
        if not s.is_cuda or s.device != dev:
            raise ValueError("miller_step: expects CUDA tensors on one "
                             "device")
        if (s.dtype != torch.int32 or s.dim() != 3
                or s.shape[:2] != (NLIMBS, G2_COEFS)
                or not s.is_contiguous()):
            raise ValueError("miller_step: expects contiguous (16, 4, B) "
                             f"int32 stacks, got {tuple(s.shape)} {s.dtype}")
    if mode == MILLER_ADD and q.shape != t.shape:
        raise ValueError("miller_step: T and Q shapes differ")
    _check_rows("miller_step", px, py)
    width = t.shape[2]
    if px.device != dev or px.shape[1] != width or py.shape[1] != width:
        raise ValueError("miller_step: P's rows and T differ in device or "
                         "width")
    if NLIMBS * FQ12_COEFS * width >= MAX_ELEMENTS:
        raise ValueError("miller_step: a tensor of 2^31 or more elements")
    t_out = torch.empty_like(t)
    line = torch.empty((NLIMBS, FQ12_COEFS, width), dtype=torch.int32,
                       device=dev)
    if width == 0:
        return t_out, line
    lib = _lib("tower.cu")
    with torch.cuda.device(dev):
        rc = lib.h2v_miller_step(
            t.data_ptr(), None if mode == MILLER_DOUBLE else q.data_ptr(),
            px.data_ptr(), px.stride(0), py.data_ptr(), py.stride(0),
            t_out.data_ptr(), line.data_ptr(), width, mode, _stream(dev))
    _raise_on(rc, "miller_step")
    _count("miller_step", width, (mode, t, q, px, py))
    return t_out, line
