"""Build, load and count the hand-written CUDA kernels.

The sources `csrc/<name>.cu` are compiled by `nvcc` into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with `ctypes`. The build happens at first use, into
`_build/` next to this package's sources (listed in `.gitignore`), and
the library's name carries a hash of the sources and flags, so an edited
kernel is rebuilt. `build_all()` compiles each source to an object with
its own `nvcc`, all started together, then links the objects, under a
lock on `_build/.lock` and renamed into place, so processes that start
together (the ranks of one run) build it once and never load a torn file.

Every wrapper adds one to `LAUNCHES[name]` where it launches its kernel
and nowhere else, and records the launch's shape, (stream rows, table
rows) — (rows per shard, table rows per shard, shards) for a stacked
launch — in `SHAPES[name]`, the last one, and in `LOG[name]`, every
one; a call on an empty stream launches nothing and adds one to
`EMPTY[name]` instead.
`reset_launches()` zeroes them all.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel sources under csrc/
SOURCES = ("quality_vol", "collapse_cavity", "split_midpoint", "interp_bary")
# measurement-only sources under csrc/, built with the kernels and called
# by nothing on the main path (chip_smoke.py phase 3)
PROBES = ("launch_floor",)

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH, "-std=c++17", "-O3",
    # no FMA contraction: the kernels reproduce the plain PyTorch
    # versions' rounding term by term (their gates compare exactly)
    "-fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
]

LAUNCHES = {name: 0 for name in SOURCES}
SHAPES: dict = {}
LOG = {name: [] for name in SOURCES}
EMPTY = {name: 0 for name in SOURCES}
# compiler log of each source (register and spill counts, `-Xptxas -v`),
# kept beside the library so that a process loading a library built
# earlier reads them too
BUILD_LOGS: dict = {}
_LIB = None


class KernelError(Exception):
    """A kernel failed to build or to launch. Not a RuntimeError, so the
    drivers' rollback to the last good iteration never absorbs it."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LOG[k].clear()
        EMPTY[k] = 0
    SHAPES.clear()


def count(name: str, rows: int, table_rows: int, shards=None) -> None:
    """Book one launch of kernel `name` over `rows` stream rows (per
    shard, for a stacked launch over `shards` shards)."""
    LAUNCHES[name] += 1
    SHAPES[name] = ((rows, table_rows) if shards is None
                    else (rows, table_rows, shards))
    LOG[name].append(SHAPES[name])


def count_empty(name: str) -> None:
    """Book one call of kernel `name`'s wrapper on an empty stream,
    which launches nothing."""
    EMPTY[name] += 1


def nvcc_path() -> str:
    p = shutil.which("nvcc")
    if p is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        p = "/usr/local/cuda/bin/nvcc"
    if p is None:
        raise KernelError(
            "nvcc not found: the CUDA kernels of parmmg_tpu_torch are "
            "built from csrc/ at first use and need the CUDA toolkit"
        )
    return p


def library_path() -> str:
    """Where the kernel library of these sources and flags is built."""
    h = hashlib.sha256()
    for f in sorted(os.listdir(SRC_DIR)):
        with open(os.path.join(SRC_DIR, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libparmmg_kernels-{h.hexdigest()[:16]}.so")


def _run(procs: dict) -> None:
    """Wait for every compiler process; raise with the logs of those
    that failed."""
    logs = {n: p.communicate()[0] for n, p in procs.items()}
    failed = [n for n, p in procs.items() if p.returncode != 0]
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{logs[n]}" for n in failed))
    BUILD_LOGS.update(logs)


@contextlib.contextmanager
def build_lock():
    """An exclusive lock on `_build/.lock`, held while a library is
    built, so that processes starting together on a cold `_build/` (the
    ranks of one run) build it once: the first to take the lock builds,
    the others find the library when they get the lock."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def _build(out: str) -> None:
    """Build the library `out` under `build_lock()`. Objects and library
    are written under names of this process and renamed into place, so
    no process ever loads a half-written file."""
    with build_lock():
        if os.path.exists(out):
            return
        nvcc = nvcc_path()
        tmp = f"{out[:-3]}.tmp{os.getpid()}"
        objs = {n: f"{tmp}.{n}.o" for n in SOURCES + PROBES}
        try:
            _run({n: subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", objs[n],
                 os.path.join(SRC_DIR, f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for n in objs})
            _run({"link": subprocess.Popen(
                [nvcc, *ARCH, "-shared", "-o", f"{tmp}.so", *objs.values()],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)})
            with open(f"{tmp}.log.json", "w") as f:
                json.dump(BUILD_LOGS, f)
            # the log first: a process that finds the library finds it too
            os.replace(f"{tmp}.log.json", f"{out[:-3]}.log.json")
            os.replace(f"{tmp}.so", out)
        finally:
            for f in (*objs.values(), f"{tmp}.so", f"{tmp}.log.json"):
                if os.path.exists(f):
                    os.remove(f)


def build_all() -> float:
    """Build the kernel library unless it is built, and load it. Returns
    the wall seconds."""
    global _LIB
    t0 = time.perf_counter()
    if _LIB is None:
        out = library_path()
        if not os.path.exists(out):
            _build(out)
        if not BUILD_LOGS and os.path.exists(f"{out[:-3]}.log.json"):
            with open(f"{out[:-3]}.log.json") as f:
                BUILD_LOGS.update(json.load(f))
        _LIB = ctypes.CDLL(out)
    return time.perf_counter() - t0


_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
# C signature of each kernel's entry points (suffix _f32 / _f64)
SIGNATURES = {
    # vert, met, C, P, tet, n, alpha, q, vol, stream
    "quality_vol": (_P, _P, _I, _I, _P, _L, _D, _P, _P, _P),
    # vert, met, C, P, tet, vol_floor, n, alpha, out, stream
    "collapse_cavity": (_P, _P, _I, _I, _P, _P, _L, _D, _P, _P),
    # vert, P, tet, newp, li, lj, n, frac, ok, stream
    "split_midpoint": (_P, _I, _P, _P, _P, _P, _L, _D, _P, _P),
    # vert, met, P, vids, pts, D, Q, bary, met_q, stream
    "interp_bary": (_P, _P, _I, _P, _P, _L, _L, _P, _P, _P),
    # rows, shards, stream (no dtype suffix)
    "launch_floor": (_L, _L, _P),
}


# the kernels that share the tile loop of csrc/tile_loop.cuh
TILE_LOOP = ("quality_vol", "collapse_cavity")


def tile_rows() -> int:
    """Rows a tile of the tile loop (csrc/tile_loop.cuh TILE)."""
    build_all()
    return ctypes.c_int.in_dll(_LIB, "tile_loop_rows").value


def row_threads() -> int:
    """Threads a CTA of the one-row-a-thread kernels
    (csrc/row_grid.cuh kRowThreads, exported by csrc/split_midpoint.cu)."""
    build_all()
    return ctypes.c_int.in_dll(_LIB, "row_threads").value


def function(name: str, dtype=None):
    """The ctypes entry point of kernel `name` for a float dtype
    (float32 or float64; None for a probe), with its argument and return
    types set."""
    import torch

    build_all()
    if dtype is None:
        fn = getattr(_LIB, name)
    else:
        sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        fn = getattr(_LIB, f"{name}_{sfx}")
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error (`cudaGetLastError`)."""
    if rc != 0:
        raise KernelError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
