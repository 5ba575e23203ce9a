"""Build, load and count the hand-written CUDA kernels.

The sources `csrc/<name>.cu` are compiled by `nvcc` into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with `ctypes`. The build happens at first use, into
`_build/` next to this package's sources (listed in `.gitignore`), and
the library's name carries a hash of the sources and flags, so an edited
kernel is rebuilt. `build_all()` compiles each source to an object with
its own `nvcc`, all started together, then links the objects.

Every wrapper adds one to `LAUNCHES[name]` where it launches its kernel
and nowhere else, and records the launch's (stream rows, table rows) in
`SHAPES[name]` — (rows per shard, table rows per shard, shards) for a
stacked launch; `reset_launches()` zeroes both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel sources under csrc/
SOURCES = ("quality_vol", "collapse_cavity", "split_midpoint", "interp_bary")

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
# compiler log of each source (register and spill counts, `-Xptxas -v`)
BUILD_LOGS: dict = {}
_LIB = None


class KernelError(Exception):
    """A kernel failed to build or to launch. Not a RuntimeError, so the
    drivers' rollback to the last good iteration never absorbs it."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.clear()


def count(name: str, rows: int, table_rows: int, shards=None) -> None:
    """Book one launch of kernel `name` over `rows` stream rows (per
    shard, for a stacked launch over `shards` shards)."""
    LAUNCHES[name] += 1
    SHAPES[name] = ((rows, table_rows) if shards is None
                    else (rows, table_rows, shards))


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


def _lib_path() -> str:
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


def build_all() -> float:
    """Build the kernel library unless it is built, and load it. Returns
    the wall seconds."""
    global _LIB
    t0 = time.perf_counter()
    if _LIB is None:
        out = _lib_path()
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = nvcc_path()
            objs = {n: f"{out[:-3]}.{n}.o" for n in SOURCES}
            _run({n: subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", objs[n],
                 os.path.join(SRC_DIR, f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for n in SOURCES})
            _run({"link": subprocess.Popen(
                [nvcc, *ARCH, "-shared", "-o", out, *objs.values()],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)})
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
}


def function(name: str, dtype):
    """The ctypes entry point of kernel `name` for a float dtype
    (float32 or float64), with its argument and return types set."""
    import torch

    sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    build_all()
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
