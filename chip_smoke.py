#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`parmmg_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit and PyTorch built for CUDA. Phases, each raising on failure:

1. print the card (`nvidia-smi` name and power limit) and build the CUDA
   kernels of `parmmg_tpu_torch/csrc/` (one `nvcc` per source, all
   started together, linked into one library, with the launch-floor
   probe); the compiler's `-Xptxas -v` log must show no spills for any
   kernel, and the SASS a row runs (the tile loop of quality_vol and
   collapse_cavity, the body of split_midpoint and interp_bary) no
   local-memory access; registers and static shared memory are printed
   (no launch takes dynamic shared memory);
2. centralized path: write the structured unit cube 12^3 with the port's
   Medit writer and run the port's CLI on it (`-hsiz 0.04 -niter 1 -hgrad
   0`, the n12-hsiz0.04 rung of bench.py; frontier sweeps, the default),
   with every kernel launch counter set to 0 just before and read just
   after; reload the output and check conformity, qmin > 0 and the
   element count in a window around the JAX package's count for the same
   command on a CPU; print each kernel's launches, the min/median/max
   stream rows of its launches and its calls on an empty stream (which
   launch nothing); then the same adaptation once more through `adapt()`
   under torch.profiler, which must give the CLI's mesh bit for bit, for
   the device busy share and the kernels that take the time; then the
   CLI with `-nofrontier` (full-table sweeps), counters read likewise,
   which must give the full-table mesh of earlier slices bit for bit
   (its element count, qmin and unit-band share);
   Then the rung once more with `-field`, a (1, 3) field linear in
   the coordinates, which must give the field-less mesh bit for bit and
   its launches, and write `<out>.fields.sol` with the linear functions
   at the output vertices (within FIELD_TOL).
2g. library API (`parmmg_tpu_torch.api`, the C ABI shim): `ParMesh.load_mesh`
   of the rung's input with `DPARAM_hsiz` 0.04, `IPARAM_niter` 1 and
   `DPARAM_hgrad` 0 must return SUCCESS with the CLI's mesh bit for bit
   and its launches; the same parameters on the rung's arrays through
   the staged setters must give a conforming mesh in the rung's window
   (and the CLI's mesh bit for bit where the staged leaves equal the
   loaded ones; which held is printed); the same buffers through the
   shim, from `native/capi_example.c` built with gcc and run as a
   process of its own on the card, must give the staged run's mesh bit
   for bit, and its `pmmgtpu_adapt_file` on the rung a conforming mesh
   with qmin > 0; `ParMesh(nparts=4)` on 2c's graded cube with
   `IPARAM_niter` 1 must return SUCCESS, launch all four kernels and
   give consistent global numberings and owners;
2d. level-set path: ls = |p - (0.5, 0.5, 0.5)| - 0.3 as the -sol of
   `-ls -hsiz 0.04 -niter 1 -hgrad 0 -out ls.vtu` on the same cube,
   counters read likewise; the .vtu, reloaded with `load_vtu`, must be
   conforming with qmin > 0, an element count in a window around the
   JAX package's for the same command on a CPU, ref-10 isosurface
   trias, an `ls` PointData array and the ref-3 volume of the
   discretized input (within LS_VOL_TOL);
2c. distributed path: the same cube with the graded iso size
   h = 0.025 + 0.05 x written as a .sol, through the CLI with `-nparts 4`
   (f32, niter 3, hgrad 1.3, -ar 45; frontier sweeps; balancing between
   iterations, the default), counters set to 0 just before and read just
   after: interp_bary must launch at least niter times and the other
   kernels at least once; an iteration may be rolled back only on the
   phase-boundary validation; some iteration must move cells between
   shards and the last one take the graph cut (each rebalancing printed
   with its trigger, cells moved, imbalance before and after and wall
   time); the merged output must be conforming with qmin > 0 and an
   element count in a window around the JAX package's count for the same
   command on a CPU; launches printed as in 2; then the same with
   `-nobalance` (frozen interfaces), with frontier and with full-table
   sweeps, which must give the element count of earlier slices; the
   balanced run once more with `-field`, as in 2; at the end of the
   script, `adapt_distributed()` with the balanced options
   again under torch.profiler, which must give the balanced CLI's mesh
   bit for bit;
2e. distributed workflow: the graded cube `-nparts 4 -pure-partitioning`
   into binary per-rank files, then `-distributed-input` from them
   (niter 3, balanced), counters read as in 2c; the per-rank input and
   output reloaded on the card must pass `assert_comm_ok`, the output,
   merged, must be conforming with qmin > 0 and an element count in the
   window of 2c; every kernel launched, interp_bary at least niter
   times; the check_comm block timed on the output;
2f. two ranks on the one card: 2c's balanced command, then 2e's
   -distributed-input step from the same per-rank files, each as two
   `python -m parmmg_tpu_torch` processes under the env contract (gloo
   on 127.0.0.1, a wall limit each), each rank with its own -out; both
   ranks' files must be equal byte for byte and give the one-process
   mesh of 2c or 2e bit for bit, and every rank must launch quality_vol,
   collapse_cavity and split_midpoint, and interp_bary at least niter
   times; each rank's remeshing wall time, gathers (calls, bytes,
   seconds) and launches are printed with the card's name and power
   limit;
3. every kernel against its plain PyTorch version on the card, at the
   shapes of its own last launch on each path it runs on (tables of P
   rows, a stream of N rows; the three sweep kernels at the centralized
   shapes on the output of 2, and at the per-shard shapes of the
   balanced run of 2c on a shard of its merged output, and likewise for
   2e, with quality_vol also at 2e's input histogram; interp_bary over
   D shards of each output) in f32 and f64, with iso (C=1)
   and seeded SPD tensor (C=6) metrics where the kernel takes them
   (split_midpoint's booleans and interp_bary's outputs bit for bit,
   the qualities within RTOL);
   timed on the device (CUPTI records through torch.profiler; the mean
   over 25 calls) and per call (CUDA events; the median of 25), after a
   warm-up, back to back on one input (so the tables and the stream sit
   in L2); each time is printed beside its bound, its share of the
   bound, its issue floor (the SASS instructions of a row from
   `cuobjdump -sass`, issued at one warp instruction a cycle, two for
   FP64 arithmetic, on each of the SMs' 4 schedulers at the card's
   maximum SM clock) and, for the one-row-a-thread kernels
   (split_midpoint, interp_bary), the launch floor: the device time of
   an empty kernel on the same grid (`csrc/launch_floor.cu`), by the
   same estimator;
4. small f64 adaptations on the card against the same runs on the CPU,
   centralized and distributed (-nobalance), with frontier and with
   full-table sweeps, distributed balanced with frontier sweeps and the
   linear field, and centralized on a level-set-discretized cube with
   the field, `adapt_stacked_input()` on 2 per-rank binary files with
   the communicator checks, and centralized after `renumber_sfc` (-rn):
   the per-sweep histories (and the rebalancings) must be equal, the
   balanced one also to its field-less run's, ls and fields within
   RTOL; on the card, the device-to-host reads inside the sweep loops
   are counted (torch's sync debug mode), and the per-rank run is timed
   without and with the communicator checks;
5. a `{"kernels": [...]}` line, the card line, and as the last line
   `{"ok": true, "device": {...}}`.

Exits non-zero without a result line when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the vector
# (non-tensor-core) float rates the kernels' scalar arithmetic runs on
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# arithmetic operations per stream row (adds, multiplies, divisions,
# square roots, one pow), counted from csrc/tet_math.cuh: volume 24;
# quality iso 70, aniso 189 on top of it; split = three volumes + gates;
# interp_bary = five 6x-volumes (23 each), the clamp and renormalisation
# (16) and the harmonic size (13)
FLOPS_PER_ROW = {
    ("quality_vol", 1): 94, ("quality_vol", 6): 213,
    ("collapse_cavity", 1): 95, ("collapse_cavity", 6): 214,
    ("split_midpoint", 0): 76, ("interp_bary", 1): 144,
}

# the main path: bench.py's n12-hsiz0.04 rung and the element count
# window its output must fall in, about 15 % either side of the JAX
# package's CLI on a CPU for the same command (frontier sweeps: 184,291
# tets; PERF.md)
CUBE_N, HSIZ = 12, 0.04
NE_RANGE = (157_000, 212_000)
# the same command with -nofrontier gives the full-table mesh of earlier
# slices bit for bit: (tets, qmin, unit-band share)
NOFRONTIER_MESH = (198_394, "0.209259", "0.874197")

# the distributed path: graded iso size h = H0 + H1 x on the same cube,
# NPARTS shards, the CLI's defaults (niter 3, hgrad 1.3, -ar 45, f32,
# frontier sweeps, balancing between iterations); the window is about
# 15 % either side of the JAX package's CLI on a CPU for this command
# (151,249 tets; PERF.md), which gives the same count for the
# distributed workflow (the graded cube partitioned into binary per-rank
# files by -pure-partitioning, then adapted from them by
# -distributed-input); with -nobalance, frontier or not, the port gives
# the count of earlier slices
GRADED_H = (0.025, 0.05)
NPARTS, NITER = 4, 3
DIST_NE_RANGE = (128_000, 174_000)
DIST_NOBALANCE_NE = 149_267

# float agreement band of tests/test_m18_kernels.py `_rtol`
RTOL = {"float32": 5e-6, "float64": 5e-11}

# the fields runs: the centralized rung and the balanced distributed
# workload once more with `-field`, a (1, 3) field linear in the
# coordinates (`linear_fields`). Fields enter no decision, so each run
# must give its field-less mesh and launches. The largest deviation from
# the linear functions at the output vertices must stay within these
# bounds, set from the same commands on a CPU (PERF.md): centralized,
# the f32 rounding of the P1 pull, 1.8e-6 in the JAX package's CLI and
# 3.8e-6 in the port's; distributed, where the surface path takes each
# boundary vertex's value from its nearest old tria, which need not hold
# it (in both packages; ROADMAP queue 3), 0.125 in the JAX package's
# CLI and 0.153 in the port's
FIELD_TOL = {"centralized": 2e-5, "distributed": 0.5}
# the level-set run: ls = |p - (0.5, 0.5, 0.5)| - LS_R on the cube as
# the -sol of `-ls -hsiz 0.04 -niter 1 -hgrad 0`, written as .vtu; the
# window is about 15 % either side of the JAX package's CLI on a CPU for
# this command (182,798 tets), and the ref-3 (inside) volume must stay
# within LS_VOL_TOL of the discretized input's 0.108760: it moved by
# 1.32e-4 in that JAX run and 1.82e-4 in the port's on a CPU (PERF.md)
LS_R = 0.3
LS_NE_RANGE = (155_000, 210_000)
LS_VOL_TOL = 5e-4

REPLACES = {
    "quality_vol": "parmmg_tpu/kernels/quality_k.py:120",
    "collapse_cavity": "parmmg_tpu/kernels/cavity_k.py:68",
    "split_midpoint": "parmmg_tpu/kernels/cavity_k.py:156",
    "interp_bary": "parmmg_tpu/kernels/interp_k.py:67",
}
SOURCE = {
    "quality_vol": "parmmg_tpu_torch/csrc/quality_vol.cu",
    "collapse_cavity": "parmmg_tpu_torch/csrc/collapse_cavity.cu",
    "split_midpoint": "parmmg_tpu_torch/csrc/split_midpoint.cu",
    "interp_bary": "parmmg_tpu_torch/csrc/interp_bary.cu",
}
# the kernels of the centralized path; interp_bary runs on the
# distributed one. Each kernel's line reports the launches and shapes of
# the path that first needs it.
CENTRAL = ("quality_vol", "collapse_cavity", "split_midpoint")


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warm: int = 3, symbol: tuple | None = None):
    """(device ms, call ms) of one call of `fn` over `reps` calls.

    Device ms: the GPU time of the kernels the calls launched, read from
    `torch.profiler` (CUPTI) records, over `reps` (a mean) — the per-call
    CUDA-event time is dominated by the host's launch overhead at these
    sizes. With `symbol`, only the records of kernels whose name holds
    each of its strings count, and a capture counts only where it holds a whole multiple
    of `reps` of them: late in a process that made many captures, a
    capture can come back with none or some of its kernel's records,
    and with a few records that are not its calls' (chip runs, PR 10).
    Such a capture is made again, up to 4 in all; where none is whole,
    device ms is None. Without `symbol` (the plain versions, tens of
    kernels a call) every record counts. Call ms: the median CUDA-event
    time around each call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    calls = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        calls.append(a.elapsed_time(b))
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        recs = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and (symbol is None or all(x in e.name for x in symbol))]
        if recs and (symbol is None or len(recs) % reps == 0):
            return sum(recs) / reps / 1e3, statistics.median(calls)
        print(f"## note: a profiler capture held {len(recs)} records of "
              f"{'/'.join(symbol or ('any kernel',))} for {reps} calls; "
              "made again",
              flush=True)
    return None, statistics.median(calls)


# what the profiler's name of each kernel's device function holds: the
# two tile-loop kernels share `tile_kernel` and differ by their epilogue
# type (csrc/quality_vol.cu, csrc/collapse_cavity.cu)
SYMBOLS = {"quality_vol": ("tile_kernel", "QualityVolOut"),
           "collapse_cavity": ("tile_kernel", "GatedOut"),
           "split_midpoint": ("split_midpoint_kernel",),
           "interp_bary": ("interp_bary_kernel",)}


def row_scales(vert, met, tet):
    """Per-row magnitude scales of (vol, q): the expressions with every
    signed sum taken over absolute values (the forward error bound the
    float comparisons are relative to — a cancelling volume is compared
    on the scale of its terms), computed in float64."""
    import torch

    from parmmg_tpu_torch.ops.common import take
    from parmmg_tpu_torch.ops.quality import ALPHA

    v, m = vert.double(), met.double()
    c = take(v, tet)
    d1, d2, d3 = ((c[:, k] - c[:, 0]).abs() for k in (1, 2, 3))
    cr = torch.stack([d1[:, 1] * d2[:, 2] + d1[:, 2] * d2[:, 1],
                      d1[:, 2] * d2[:, 0] + d1[:, 0] * d2[:, 2],
                      d1[:, 0] * d2[:, 1] + d1[:, 1] * d2[:, 0]], 1)
    s_vol = (cr * d3).sum(1) / 6.0
    e = [(c[:, b] - c[:, a]).abs() for a, b in
         ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))]
    m4 = take(m, tet).mean(1)
    cond = torch.zeros_like(s_vol)
    if m.shape[1] == 6:
        a11, a12, a13, a22, a23, a33 = m4.abs().unbind(1)
        s_det = (a11 * (a22 * a33 + a23 * a23) + a12 * (a12 * a33 + a23 * a13)
                 + a13 * (a12 * a23 + a22 * a13))
        m11, m12, m13, m22, m23, m33 = m4.unbind(1)
        det = (m11 * (m22 * m33 - m23 * m23) - m12 * (m12 * m33 - m23 * m13)
               + m13 * (m12 * m23 - m22 * m13))
        cond = 0.5 * s_det / det.abs()
        rap = sum(x[:, 0] * (a11 * x[:, 0] + a12 * x[:, 1] + a13 * x[:, 2])
                  + x[:, 1] * (a12 * x[:, 0] + a22 * x[:, 1] + a23 * x[:, 2])
                  + x[:, 2] * (a13 * x[:, 0] + a23 * x[:, 1] + a33 * x[:, 2])
                  for x in e)
        s_volm = s_vol * s_det.sqrt()
    else:
        h = m4[:, 0]
        rap = sum((x * x).sum(1) for x in e) / (h * h).clamp(min=1e-30)
        s_volm = s_vol / (h ** 3).clamp(min=1e-30)
    s_q = ALPHA * s_volm / rap.clamp(min=1e-30) ** 1.5 * (1.0 + cond)
    return s_vol, s_q


def check_close(got, ref, scale, dtype_name: str, what: str) -> float:
    """Require |got - ref| <= rtol * max(|ref|, scale) row by row;
    return the max absolute error."""
    import torch

    g, r = got.double(), ref.double()
    err = (g - r).abs()
    tol = RTOL[dtype_name] * torch.maximum(r.abs(), scale)
    bad = ~(err <= tol)
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} rows outside rtol "
            f"{RTOL[dtype_name]} of the row scale")
    return float(err.max()) if err.numel() else 0.0


def spd_sym6(P: int, h: float, dtype, device, seed: int = 5):
    """Seeded SPD tensors (m11 m12 m13 m22 m23 m33) around (1/h^2) I."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    A = rng.normal(scale=0.5, size=(P, 3, 3)) + np.eye(3)
    M = (A @ np.transpose(A, (0, 2, 1)) + 0.1 * np.eye(3)) / h ** 2
    s6 = M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    return torch.as_tensor(s6, dtype=dtype, device=device).contiguous()


def fit_rows(t, rows: int, fill):
    """`t` cut or padded (with `fill`) to `rows` leading rows."""
    import torch

    if t.shape[0] >= rows:
        return t[:rows].contiguous()
    pad = torch.full((rows - t.shape[0],) + tuple(t.shape[1:]), fill,
                     dtype=t.dtype, device=t.device)
    return torch.cat([t, pad]).contiguous()


def bound(name: str, C: int, P: int, N: int, itemsize: int, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes the kernel must move
    (tables and streams read once, outputs written once) over the HBM
    rate and its operations over the vector peak. Both are computed so
    that a kernel whose arithmetic outgrows its traffic is bounded
    right; at the main path's shapes the bytes are the larger for all
    three."""
    if name == "split_midpoint":
        # tet, newp, li, lj in; one bool out
        nbytes = P * 3 * itemsize + N * (16 + 3 * itemsize + 8 + 1)
    elif name == "interp_bary":
        # per shard (P, N are totals over the shards here): vids and pts
        # in, bary and the size out (_interp_bary_cost of the JAX kernel)
        nbytes = P * (3 + C) * itemsize + N * (16 + (3 + 4 + C) * itemsize)
    else:
        # tet in, two float columns per row (q and vol out, or the
        # floor in and the gated quality out)
        nbytes = P * (3 + C) * itemsize + N * (16 + 2 * itemsize)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ROW[(name, C)] * N / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(name, fn, fn0, err, bound_ms, bound_by) -> dict:
    """Times of kernel `name`'s wrapper `fn` and its plain version
    `fn0`: device time (CUPTI) where the profiler saw the kernels, else
    CUDA-event time."""
    dev, call = time_ms(fn, symbol=SYMBOLS[name])
    dev0, call0 = time_ms(fn0)
    if dev is None or dev0 is None:
        print("## note: the profiler recorded no device activity; kernel "
              "times are CUDA-event times per call")
        dev, dev0 = call, call0
    return dict(ms=dev, call_ms=call, plain_ms=dev0, plain_call_ms=call0,
                err=err, bound_ms=bound_ms, bound_by=bound_by)


def launch_floor(rows: int, shards: int):
    """Device ms of an empty kernel on the grid of the one-row-a-thread
    kernels over `rows` rows in each of `shards` shards
    (`csrc/launch_floor.cu`), by `time_ms`'s estimator; None where the
    profiler recorded no device activity."""
    import torch

    from parmmg_tpu_torch.kernels import build

    fn = build.function("launch_floor")
    stream = torch.cuda.current_stream().cuda_stream
    return time_ms(lambda: build.check(fn(rows, shards, stream),
                                       "launch_floor"),
                   symbol=("launch_floor_kernel",))[0]


def floors(name: str, dtn: str, C: int, N: int, r: dict) -> str:
    """The issue floor of kernel `name` over N rows, and the launch floor
    in `r` where it was measured, as printed beside the bound."""
    n_ins, cycles, floor_ms = issue_floor(name, dtn, C, N)
    out = ("   issue floor not measured (row body not found in the SASS)"
           if n_ins is None else
           f"   issue floor {floor_ms:.4f} ms ({n_ins} SASS instructions, "
           f"{cycles} issue cycles a row)")
    if "launch_floor_ms" in r:
        lf = r["launch_floor_ms"]
        out += (", launch_floor_ms not measured" if lf is None else
                f", launch_floor_ms {lf:.4f} (an empty kernel on the same "
                "grid)")
    return out


def phase_times(text: str) -> dict:
    """Phase -> seconds from the CLI's `-- PHASE TIMES (s)` table."""
    out, on = {}, False
    for line in text.splitlines():
        if "PHASE TIMES" in line:
            on = True
            continue
        if on and line.strip():
            parts = line.split()
            out[" ".join(parts[:-1])] = float(parts[-1])
    return out


def ptxas_functions(log: str) -> dict:
    """Entry function -> {registers, stack, spill_stores, spill_loads,
    smem} (bytes) from an `nvcc -Xptxas -v` log."""
    out, fn, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            out[fn] = dict(registers=0, stack=0, spill_stores=0,
                           spill_loads=0, smem=0)
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            # an entry function's, or a subroutine's (not reported)
            props = m.group(1) if m.group(1) in out else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and props:
            out[props].update(stack=int(m[1]), spill_stores=int(m[2]),
                              spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn]["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", ln)
            out[fn]["smem"] = int(m[1]) if m else 0
    return out


# the metric widths C each kernel's instantiations take (0: none)
WIDTHS = {"quality_vol": (1, 6), "collapse_cavity": (1, 6),
          "split_midpoint": (0,), "interp_bary": (1,)}


def build_kernels() -> None:
    """Phase 1: one nvcc per kernel source, all started together, then
    one link into the kernel library. Every kernel must be free of
    spills, and the SASS a row runs free of local-memory accesses (a
    per-thread array that the compiler cannot keep in registers, such as
    corners indexed through a table in constant memory), at both dtypes
    and each C."""
    from parmmg_tpu_torch import kernels

    build_s = kernels.build_all()
    print(f"## build: {len(kernels.NAMES)} CUDA kernels in {build_s:.2f} s")
    logs = kernels.build.BUILD_LOGS
    for name in kernels.NAMES:
        require(name in logs, f"no compiler log for {name}")
        for fn, f in ptxas_functions(logs[name]).items():
            print(f"   {name}: {f['registers']} registers, {f['smem']} B "
                  f"static + 0 B dynamic smem, {f['stack']} B stack, spills "
                  f"{f['spill_stores']}/{f['spill_loads']} B  {fn[:72]}")
            require(f["spill_stores"] == f["spill_loads"] == 0,
                    f"{name}: {fn} spills: {f}")
    for name in kernels.NAMES:
        for dtn in ("float32", "float64"):
            for C in WIDTHS[name]:
                body = row_sass(name, dtn, C)
                require(body is not None,
                        f"{name} {dtn} C={C}: row body not found in SASS")
                local = [t for t in body if re.search(r"\b(LDL|STL)\b", t)]
                require(not local, f"{name} {dtn} C={C}: the row body "
                        f"reads or writes local memory: {local[:4]}")


# the epilogue of each tile-loop kernel (csrc/<name>.cu), which its
# instantiations' names carry
EPILOGUE = {"quality_vol": "QualityVolOut", "collapse_cavity": "GatedOut"}
_SASS: dict = {}


def sass_functions() -> dict:
    """Function name -> [(address, instruction)] of the kernel library's
    SASS (`cuobjdump -sass`), read once."""
    from parmmg_tpu_torch.kernels import build

    if not _SASS:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        text = subprocess.run([tool, "-sass", build.library_path()],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for part in re.split(r"\n\s*Function : ", text)[1:]:
            _SASS[part.split("\n", 1)[0].strip()] = [
                (int(a, 16), t.strip()) for a, t in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
    return _SASS


_BRA = re.compile(r"\bBRA(?:\.[A-Z.]+)?\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)")


def row_sass(name: str, dtype_name: str, C: int):
    """The SASS instructions a row of kernel `name` runs at (dtype, C).
    For the tile-loop kernels: the loop body from where its two
    index-read paths join to its back edge (the gathers, the arithmetic
    with the stubs of the division's out-of-line slow path, the
    epilogue, the loop control). For the one-row-a-thread kernels: the
    body from the entry to the first unconditional EXIT. Both with each
    subroutine the body calls where no branch jumps over the call (the
    f64 `pow`; the slow paths of division and square root run only for
    operands outside their fast range). None if the body is not
    found."""
    from parmmg_tpu_torch.kernels.build import TILE_LOOP

    ty = dict(float32="f", float64="d")[dtype_name]
    if name in TILE_LOOP:
        key, tag = f"tile_kernelI{ty}Li{C}E", EPILOGUE[name]
    else:
        key, tag = f"{name}_kernelI{ty}E", ""
    fns = [v for k, v in sass_functions().items() if key in k and tag in k]
    if len(fns) != 1:
        return None
    ins = fns[0]
    jumps = [(a, int(m[1], 16), t.startswith("@")) for a, t in ins
             if (m := _BRA.search(t))]
    if name in TILE_LOOP:
        # the tile loop's back edge: the backward branch of the longest
        # span
        hi, head = max(((a, b) for a, b, _ in jumps if b < a),
                       key=lambda ab: ab[0] - ab[1], default=(0, 0))
        lo = next((b for a, b, pred in jumps
                   if head < a < hi and not pred and a < b < hi), None)
        if lo is None:
            return None
    else:
        lo = ins[0][0]
        hi = next((a for a, t in ins if re.match(r"EXIT\b", t)), None)
        if hi is None:
            return None
    body = [t for a, t in ins if lo <= a <= hi]
    for a, t in ins:
        m = re.search(r"\bCALL\S*\s+0x([0-9a-f]+)", t)
        if m and lo <= a <= hi and not any(
                src < a < dst for src, dst, _ in jumps if lo <= src):
            target = int(m[1], 16)
            ret = next((b for b, u in ins if b >= target and "RET" in u),
                       target)
            body += [u for b, u in ins if target <= b <= ret]
    return body


def max_sm_hz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60, check=True)
    return float(r.stdout.split()[0]) * 1e6


# FP64 arithmetic, which an H100 issues at half the FP32 rate (16 lanes a
# scheduler): two cycles a warp instruction
_FP64 = re.compile(r"^(?:@!?U?P\w+\s+)?D(?:ADD|MUL|FMA|SETP|MNMX)\b")


def issue_floor(name: str, dtype_name: str, C: int, N: int):
    """(SASS instructions a row, issue cycles a row, ms) of kernel `name`
    over N rows, one row a thread: the time the card's
    schedulers (4 an SM, at the maximum SM clock) take to issue them,
    one warp instruction a cycle and two for FP64 arithmetic. Other
    pipes slower than one a cycle (MUFU, conversions) are counted at one,
    so this is a lower bound."""
    import torch

    body = row_sass(name, dtype_name, C)
    if body is None:
        return None, None, None
    cycles = sum(2 if _FP64.match(t) else 1 for t in body)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return len(body), cycles, (cycles * N / 32 / (sms * 4 * max_sm_hz())
                               * 1e3)


def launch_report(label: str) -> None:
    """Print, for the path just run, each kernel's launches, the min /
    median / max stream rows of its launches (per shard for a stacked
    launch) and its calls on an empty stream, which launch nothing."""
    from parmmg_tpu_torch import kernels

    parts = []
    for k in kernels.NAMES:
        rows = sorted(s[0] for s in kernels.LOG[k])
        shape = (f"N min {rows[0]} median {statistics.median(rows):g} "
                 f"max {rows[-1]}" if rows else "no launch")
        parts.append(f"{k} {kernels.LAUNCHES[k]} ({shape}; "
                     f"{kernels.EMPTY[k]} empty calls)")
    print(f"## {label} launches: " + ", ".join(parts))


def linear_fields(v):
    """The (1, 3) field of the fields runs at the points `v`: 1 + x + 2y
    + 3z and (y, z, x)."""
    import numpy as np

    return np.stack([1 + v[:, 0] + 2 * v[:, 1] + 3 * v[:, 2],
                     v[:, 1], v[:, 2], v[:, 0]], axis=1)


def write_field_sol(work: str, verts) -> list:
    """Write the linear field at `verts` as `work`/f.sol; returns the CLI
    flags that carry it."""
    from parmmg_tpu_torch.io import medit

    fsol = os.path.join(work, "f.sol")
    medit.save_sol(fsol, linear_fields(verts), [medit.SOL_SCALAR,
                                                medit.SOL_VECTOR])
    return ["-field", fsol]


def check_fields_file(out: str, label: str) -> float:
    """The `<out>.fields.sol` a `-field` run wrote next to the Medit mesh
    `out` must hold the linear functions at the output vertices within
    FIELD_TOL[`label`]. Runs on the host (it also checks CPU runs of
    either package). Returns the largest deviation."""
    from parmmg_tpu_torch.io import medit

    vals, ncomp = medit.load_fields(os.path.splitext(out)[0] + ".fields.sol")
    v = medit.read_mesh(out).verts
    require(ncomp == (1, 3) and vals.shape == (len(v), 4),
            f"{label} -field: fields file of shape {vals.shape}, "
            f"ncomp {ncomp}")
    dev = abs(vals - linear_fields(v)).max(axis=1)
    err = float(dev.max())
    print(f"## {label} -field: {len(v)} vertices, largest deviation from "
          f"the linear field {err:.3g} (bound {FIELD_TOL[label]:.3g}), "
          f"{int((dev > 1e-5).sum())} vertices off by more than 1e-5")
    require(err <= FIELD_TOL[label], f"{label} -field: deviation {err} "
            f"from the linear field above {FIELD_TOL[label]}")
    return err


def require_same_mesh(a, b, what: str) -> None:
    """Meshes `a` and `b` equal entity for entity, bit for bit."""
    a, b = a.to_numpy(), b.to_numpy()
    for k in ("verts", "tets", "trias", "met"):
        require(a[k].shape == b[k].shape
                and bool((a[k].astype(b[k].dtype) == b[k]).all()),
                f"{what} ({k})")


def same_run(m, launches, label: str, m_f, launches_f) -> None:
    """The `-field` run of a path (`m_f`, `launches_f`) gave the
    field-less run's mesh bit for bit and its launches."""
    require_same_mesh(m_f, m, f"{label} -field: the mesh differs from the "
                      "field-less run's")
    require(launches_f == launches, f"{label} -field: launches "
            f"{launches_f}, the field-less run's {launches}")
    print(f"## {label} -field: the field-less run's mesh ({int(m.ntet)} "
          f"tets) bit for bit and its launches {launches}")


def main_path(n: int, hsiz: float, ne_range, extra=(), expect=None,
              fields=False):
    """Phase 2: the port's CLI on the unit cube n^3 (with the `extra`
    flags, and with `fields` the linear field as `-field`), launch
    counters set to 0 just before and read just after. The element count
    must fall in `ne_range`, or with `expect` = (tets, qmin, in_band) the
    mesh must give those numbers. Returns (output mesh on the card,
    launches, shapes of each kernel's last launch)."""
    import torch

    from parmmg_tpu_torch import __main__ as cli
    from parmmg_tpu_torch import kernels
    from parmmg_tpu_torch.core.mesh import Mesh
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.ops import quality
    from parmmg_tpu_torch.utils import conformity, gen

    label = "main path" + "".join(f" {x}" for x in extra) + (
        " -field" if fields else "")
    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        cube = os.path.join(work, f"cube{n}.mesh")
        out = os.path.join(work, "out.mesh")
        raw = gen.unit_cube(n)
        medit.save_mesh(Mesh.from_numpy(raw["verts"], raw["tets"],
                                        trias=raw["trias"],
                                        trrefs=raw["trrefs"], device="cpu"),
                        cube)
        argv = [cube, "-hsiz", str(hsiz), "-niter", "1", "-hgrad", "0",
                "-out", out, *extra]
        if fields:
            argv += write_field_sol(work, raw["verts"])
        print(f"## {label}: python -m parmmg_tpu_torch {' '.join(argv)}",
              flush=True)
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, shapes = dict(kernels.LAUNCHES), dict(kernels.SHAPES)
        print(buf.getvalue())
        launch_report(label)
        require(rc == 0, f"CLI exited {rc}")
        m = medit.load_mesh(out, medit.met_filename(out), device="cuda")
        if fields:
            check_fields_file(out, "centralized")
    # a wrapper launches its kernel only for CUDA tensors: every counter
    # above 0 shows the main path's mesh lived on the card
    for name in CENTRAL:
        require(launches[name] > 0, f"kernel {name} never launched on the "
                f"{label}")
    rep = conformity.check_mesh(m)
    require(rep.ok, f"output mesh not conforming: {rep}")
    h = quality.quality_histogram(m)
    ne, qmin, qavg = int(h.ne), float(h.qmin), float(h.qavg)
    in_band = quality.in_band_fraction(quality.mesh_length_stats(m))
    require(qmin > 0, f"qmin {qmin} <= 0")
    if expect is None:
        require(ne_range[0] <= ne <= ne_range[1],
                f"ne {ne} outside {ne_range}")
    else:
        got = (ne, f"{qmin:.6f}", f"{in_band:.6f}")
        require(got == expect, f"{label}: (ne, qmin, in_band) {got}, not "
                f"the full-table mesh's {expect}")
    print(f"## {label}: wall {wall:.3f} s, phases " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phase_times(buf.getvalue()).items()))
    print(f"## {label}: ne {ne} np {int(m.npoin)} qmin {qmin:.6f} "
          f"qavg {qavg:.6f} in_band {in_band:.6f} conforming"
          + ("" if expect is None else ", the full-table mesh"))
    return m, launches, shapes


def _short(name: str) -> str:
    """A kernel's name without namespaces, template arguments and
    parameters."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep)[0]
    return name.split("::")[-1] or name


def profile_main_path(n: int, hsiz: float, cli_out) -> None:
    """Phase 2b: the main path's adaptation once more, called through
    `adapt()` under torch.profiler (CUPTI): device busy share of the
    wall time and the kernels that take it. The mesh must equal the
    CLI's output `cli_out` entity for entity — a GPU run repeats bit for
    bit. Launch counters are not read here."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from parmmg_tpu_torch.models.adapt import AdaptOptions, adapt
    from parmmg_tpu_torch.utils import gen

    mesh = gen.unit_cube_mesh(n)
    opts = AdaptOptions(hsiz=hsiz, niter=1, hgrad=None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out, _ = adapt(mesh, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require_same_mesh(out, cli_out,
                      "the repeated adaptation differs from the CLI's")
    print(f"## repeat: adapt() under torch.profiler gave the CLI's mesh "
          f"({int(out.ntet)} tets) bit for bit")
    _device_profile(prof, wall, "adapt under torch.profiler")


def _device_profile(prof, wall: float, label: str) -> None:
    """Print the device busy share of `wall` and the top device kernels
    of a torch.profiler capture. Reads the profiler's raw records: its
    `events()` builds an object tree over them, which took ~5 minutes
    for the 1.47 million records of the distributed rerun on an H100's
    host."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        us = e.duration_ns() / 1e3
        spans.append((e.start_ns() / 1e3, e.start_ns() / 1e3 + us))
        k = _short(e.name())
        t, cnt = by_name.get(k, (0.0, 0))
        by_name[k] = (t + us, cnt + 1)
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    print(f"## profile ({label}): wall {wall:.3f} s, device busy "
          f"{busy / 1e6:.3f} s ({100 * busy / 1e6 / wall:.1f} %), "
          f"{len(spans)} device activities")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for k, (us, cnt) in top:
        print(f"   {us / 1e3:10.3f} ms  {cnt:7d} x  {k}")


def write_graded_cube(work: str, n: int):
    """The unit cube n^3 and its graded iso size h = H0 + H1 x as Medit
    files written by the port. Returns (mesh path, sol path)."""
    from parmmg_tpu_torch.core.mesh import Mesh
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.utils import gen

    raw = gen.unit_cube(n)
    cube = os.path.join(work, f"cube{n}.mesh")
    sol = os.path.join(work, "graded.sol")
    medit.save_mesh(Mesh.from_numpy(raw["verts"], raw["tets"],
                                    trias=raw["trias"], trrefs=raw["trrefs"],
                                    device="cpu"), cube)
    h = GRADED_H[0] + GRADED_H[1] * raw["verts"][:, 0]
    medit.save_sol(sol, h[:, None], [medit.SOL_SCALAR])
    return cube, sol


def distributed_path(n: int, ne_range, extra=(), expect_ne=None,
                     fields=False):
    """Phase 2c: the port's CLI with `-nparts NPARTS` (and the `extra`
    flags, and with `fields` the linear field as `-field`) on the graded
    cube, launch counters set to 0 just before and read just after. The element count must fall in `ne_range`, or equal
    `expect_ne`. Without -nobalance, some iteration must move cells and
    the last one take the graph cut. Returns (merged output mesh on the
    card, launches, shapes)."""
    import torch

    from parmmg_tpu_torch import __main__ as cli
    from parmmg_tpu_torch import kernels
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.ops import quality
    from parmmg_tpu_torch.utils import conformity

    label = "distributed path" + "".join(f" {x}" for x in extra) + (
        " -field" if fields else "")
    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        cube, sol = write_graded_cube(work, n)
        out = os.path.join(work, "dist.mesh")
        argv = [cube, "-sol", sol, "-nparts", str(NPARTS),
                "-niter", str(NITER), "-out", out, *extra]
        if fields:
            argv += write_field_sol(work, medit.read_mesh(cube).verts)
        print(f"## {label}: python -m parmmg_tpu_torch {' '.join(argv)}",
              flush=True)
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, shapes = dict(kernels.LAUNCHES), dict(kernels.SHAPES)
        print(buf.getvalue())
        launch_report(label)
        require(rc == 0, f"CLI exited {rc}")
        m = medit.load_mesh(out, medit.met_filename(out), device="cuda")
        if fields:
            check_fields_file(out, "distributed")
    check_rollbacks([ln for ln in buf.getvalue().splitlines()
                     if "rolled back" in ln], f"the {label} CLI")
    check_rebalancing(buf.getvalue(), label, "-nobalance" not in extra)
    require(launches["interp_bary"] >= NITER,
            f"interp_bary launched {launches['interp_bary']} times on the "
            f"{label}, fewer than niter={NITER}")
    for name in kernels.NAMES:
        require(launches[name] > 0, f"kernel {name} never launched on the "
                f"{label}")
    rep = conformity.check_mesh(m)
    require(rep.ok, f"merged output not conforming: {rep}")
    h = quality.quality_histogram(m)
    ne, qmin = int(h.ne), float(h.qmin)
    require(qmin > 0, f"distributed qmin {qmin} <= 0")
    if expect_ne is None:
        require(ne_range[0] <= ne <= ne_range[1],
                f"distributed ne {ne} outside {ne_range}")
    else:
        require(ne == expect_ne, f"{label}: ne {ne}, not the count "
                f"{expect_ne} of earlier slices")
    in_band = quality.in_band_fraction(quality.mesh_length_stats(m))
    print(f"## {label}: wall {wall:.3f} s, phases " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phase_times(buf.getvalue()).items()))
    print(f"## {label}: ne {ne} np {int(m.npoin)} qmin {qmin:.6g} "
          f"qavg {float(h.qavg):.6f} in_band {in_band:.6f} conforming")
    return m, launches, shapes


# the one failure a rollback may absorb on the distributed path: the
# phase-boundary validation (ROADMAP queue 3); a kernel's build or launch
# failure raises through
ROLLBACK = "(NumericalError): phase-boundary validation failed"


def check_rollbacks(lines, what: str) -> None:
    """Each rolled-back iteration in `lines` (the CLI's `## iteration k
    rolled back (Error): message` form) must be the validation failure."""
    for ln in lines:
        require(ROLLBACK in ln, f"{what}: an iteration was rolled back on "
                f"another failure than the validation: {ln.strip()}")
    if lines:
        print(f"## {what}: {len(lines)} iteration(s) rolled back on the "
              "phase-boundary validation")


_REBAL = re.compile(r"## iteration (\d+) rebalanced \(([\w-]+)\): (\d+) "
                    r"cells moved, imbalance (\S+) -> (\S+), (\S+) s")


def check_rebalancing(text: str, label: str, balanced: bool) -> None:
    """The CLI's `## iteration k rebalanced (trigger): ...` lines of a
    run: printed one a line; with balancing some iteration must have
    moved cells and the last one taken the graph cut, without none may
    appear."""
    rows = [m.groups() for m in _REBAL.finditer(text)]
    for it, trig, cells, pre, post, wall in rows:
        print(f"## {label}: balancing it {it}: {trig}, {cells} cells moved, "
              f"imbalance {pre} -> {post}, block wall {wall} s")
    if not balanced:
        require(not rows, f"{label}: rebalanced with -nobalance")
        return
    require(any(int(r[2]) > 0 for r in rows),
            f"{label}: no iteration moved cells between shards")
    require(any(int(r[0]) == NITER - 1 and r[1] == "graph" for r in rows),
            f"{label}: the last iteration did not take the graph cut")


def distributed_input_path(n: int, ne_range):
    """Phase 2e: the distributed workflow through the port's CLI on the
    graded cube: `-pure-partitioning` into binary per-rank files
    `parts.<r>.meshb/.solb`, then `-distributed-input` from them
    (`-nparts NPARTS -niter NITER`, balancing between iterations, the
    default) into per-rank output, launch counters set to 0 just before
    that run and read just after. The per-rank input and output are
    reloaded on the card with `load_mesh_distributed` and must pass
    `assert_comm_ok`; the output, numbered and merged, must be
    conforming with qmin > 0 and an element count in `ne_range`; every
    kernel must launch, interp_bary at least niter times. The driver's
    check_comm block (`rebuild_comm`, then `assert_comm_ok`) is timed
    on the reloaded output. Returns (merged output on the card, launches,
    shapes, the shape of quality_vol's smallest launch: a shard's input
    histogram, which no other path launches)."""
    import torch

    from parmmg_tpu_torch import __main__ as cli
    from parmmg_tpu_torch import kernels
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.ops import quality
    from parmmg_tpu_torch.parallel import chkcomm
    from parmmg_tpu_torch.parallel.distribute import (
        assign_global_ids, merge_shards, rebuild_comm)
    from parmmg_tpu_torch.utils import conformity

    label = "distributed input"
    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        cube, sol = write_graded_cube(work, n)
        parts = os.path.join(work, "parts.meshb")
        out = os.path.join(work, "dist.meshb")
        steps = (
            ("-pure-partitioning", [cube, "-sol", sol, "-nparts",
                                    str(NPARTS), "-pure-partitioning",
                                    "-out", parts]),
            ("-distributed-input", [parts, "-sol",
                                    medit.met_filename(parts), "-nparts",
                                    str(NPARTS), "-distributed-input",
                                    "-niter", str(NITER), "-out", out]))
        texts = {}
        for step, argv in steps:
            print(f"## {label} {step}: python -m parmmg_tpu_torch "
                  f"{' '.join(argv)}", flush=True)
            kernels.reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            texts[step] = buf.getvalue()
            require(rc == 0, f"{label} {step}: CLI exited {rc}")
            print(f"## {label} {step}: wall {wall:.3f} s, phases "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in
                              phase_times(buf.getvalue()).items()))
            if step == "-pure-partitioning":
                for r in range(NPARTS):
                    for name in (medit.shard_filename(parts, r),
                                 medit.met_filename(
                                     medit.shard_filename(parts, r))):
                        require(medit.is_binary_file(name),
                                f"{label}: {name} is not a binary file")
        launches, shapes = dict(kernels.LAUNCHES), dict(kernels.SHAPES)
        q_in = min(kernels.LOG["quality_vol"])
        print(texts["-distributed-input"])
        launch_report(label)
        t0 = time.perf_counter()
        reps = []
        for name in (parts, out):
            st, comm = medit.load_mesh_distributed(
                name, NPARTS, metpath=medit.met_filename(name),
                device="cuda")
            reps.append(chkcomm.assert_comm_ok(st, comm, tol=1e-6))
        t_reload = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            chkcomm.assert_comm_ok(st, rebuild_comm(st), tol=1e-6)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        st = assign_global_ids(st)
        m = merge_shards(st, rebuild_comm(st))
    print(f"## {label}: reloaded input and output pass assert_comm_ok "
          f"(tol 1e-6): {reps}; reload and checks {t_reload:.3f} s; the "
          f"check_comm block on the output (rebuild_comm, assert_comm_ok) "
          f"{', '.join(f'{w:.4f}' for w in walls)} s")
    check_rollbacks([ln for ln in texts["-distributed-input"].splitlines()
                     if "rolled back" in ln], f"the {label} CLI")
    check_rebalancing(texts["-distributed-input"], label, True)
    require(launches["interp_bary"] >= NITER,
            f"interp_bary launched {launches['interp_bary']} times on the "
            f"{label}, fewer than niter={NITER}")
    for name in kernels.NAMES:
        require(launches[name] > 0, f"kernel {name} never launched on the "
                f"{label}")
    rep = conformity.check_mesh(m)
    require(rep.ok, f"{label}: merged output not conforming: {rep}")
    h = quality.quality_histogram(m)
    ne, qmin = int(h.ne), float(h.qmin)
    require(qmin > 0, f"{label}: qmin {qmin} <= 0")
    require(ne_range[0] <= ne <= ne_range[1],
            f"{label}: ne {ne} outside {ne_range}")
    in_band = quality.in_band_fraction(quality.mesh_length_stats(m))
    print(f"## {label}: ne {ne} np {int(m.npoin)} qmin {qmin:.6g} "
          f"qavg {float(h.qavg):.6f} in_band {in_band:.6f} conforming")
    return m, launches, shapes, q_in


# phase 2f: the ranks of a two-process world on the one card, and the wall
# limit past which a rank process is killed
RANKS = 2
RANK_WALL_S = 600
_RANK_LINE = re.compile(r"^## rank (\d+) of (\d+): (\{.*\})$", re.M)


def run_ranks(argv_of, label: str, card: str) -> list:
    """`python -m parmmg_tpu_torch` as RANKS processes under the env
    contract (gloo on 127.0.0.1, a free port), rank r on `argv_of(r)`,
    each killed past RANK_WALL_S. Every rank must exit 0, roll back only
    on the phase-boundary validation, and launch quality_vol,
    collapse_cavity and split_midpoint, and interp_bary at least niter
    times (its own `## rank r of N` line: gathers and launches). Prints
    each rank's remeshing wall time, gathers (calls, bytes, seconds) and
    launches. Returns the ranks' reports."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    for r in range(RANKS):
        env = dict(os.environ, PMMGTPU_COORDINATOR=f"127.0.0.1:{port}",
                   PMMGTPU_NUM_PROCS=str(RANKS), PMMGTPU_PROC_ID=str(r))
        argv = [sys.executable, "-m", "parmmg_tpu_torch", *argv_of(r)]
        print(f"## {label}, rank {r}: {' '.join(argv[1:])}", flush=True)
        procs.append(subprocess.Popen(argv, cwd=root, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    texts = []
    try:
        for p in procs:
            left = max(1.0, t0 + RANK_WALL_S - time.perf_counter())
            try:
                texts.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                texts.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    reps = []
    for r, (p, text) in enumerate(zip(procs, texts)):
        require(p.returncode == 0, f"{label}: rank {r} exited "
                f"{p.returncode}:\n{text[-6000:]}")
        m = _RANK_LINE.search(text)
        require(m is not None and int(m[1]) == r and int(m[2]) == RANKS,
                f"{label}: rank {r} printed no rank line:\n{text[-3000:]}")
        rep = json.loads(m[3])
        rep["remeshing_s"] = phase_times(text).get("remeshing")
        check_rollbacks([ln for ln in text.splitlines()
                         if "rolled back" in ln], f"{label}, rank {r}")
        launches = rep["launches"]
        require(launches["interp_bary"] >= NITER,
                f"{label}: rank {r} launched interp_bary "
                f"{launches['interp_bary']} times, fewer than niter={NITER}")
        for name in CENTRAL:
            require(launches[name] > 0, f"{label}: rank {r} never "
                    f"launched {name}")
        print(f"## {label}, rank {r} [{card}]: remeshing "
              f"{rep['remeshing_s']} s, {rep['gathers']} gathers, "
              f"{rep['gather_bytes']} bytes, {rep['gather_s']} s in them; "
              f"launches {launches}", flush=True)
        reps.append(rep)
    require(len({r["gathers"] for r in reps}) == 1,
            f"{label}: the ranks made different numbers of gathers")
    print(f"## {label}: {RANKS} ranks, {wall:.1f} s wall", flush=True)
    return reps


def same_files(names, what: str) -> None:
    """The files `names` (one a rank) are equal byte for byte."""
    blobs = []
    for name in names:
        with open(name, "rb") as f:
            blobs.append(f.read())
    require(all(b == blobs[0] for b in blobs), f"{what}: the ranks' files "
            f"{names} differ")


def two_rank_path(n: int, m_d, m_in, card: str) -> dict:
    """Phase 2f: the balanced distributed command of 2c, then 2e's
    -distributed-input step, each as RANKS `python -m parmmg_tpu_torch`
    processes on the one card (`run_ranks`), each rank with its own
    -out. Both ranks' outputs must be equal byte for byte, and equal the
    one-process mesh of 2c (`m_d`) or 2e (`m_in`, merged as there) bit
    for bit. Returns {step: the ranks' reports}."""
    from parmmg_tpu_torch import __main__ as cli
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.parallel.distribute import (
        assign_global_ids, merge_shards, rebuild_comm)

    out = {}
    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        cube, sol = write_graded_cube(work, n)
        label = "two ranks, distributed path"
        dist = [os.path.join(work, f"dist{r}.mesh") for r in range(RANKS)]
        out["distributed"] = run_ranks(
            lambda r: [cube, "-sol", sol, "-nparts", str(NPARTS), "-niter",
                       str(NITER), "-out", dist[r]], label, card)
        same_files(dist, label)
        same_files([medit.met_filename(d) for d in dist], label)
        m = medit.load_mesh(dist[0], medit.met_filename(dist[0]),
                            device="cuda")
        require_same_mesh(m, m_d, f"{label}: the mesh differs from the "
                          "one-process run's")
        print(f"## {label}: both ranks wrote the one-process mesh "
              f"({int(m.ntet)} tets) bit for bit", flush=True)

        label = "two ranks, distributed input"
        parts = os.path.join(work, "parts.meshb")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main([cube, "-sol", sol, "-nparts", str(NPARTS),
                           "-pure-partitioning", "-out", parts])
        require(rc == 0, f"{label} -pure-partitioning: CLI exited {rc}")
        dins = [os.path.join(work, f"din{r}.meshb") for r in range(RANKS)]
        out["distributed input"] = run_ranks(
            lambda r: [parts, "-sol", medit.met_filename(parts), "-nparts",
                       str(NPARTS), "-distributed-input", "-niter",
                       str(NITER), "-out", dins[r]], label, card)
        for s in range(NPARTS):
            shard = [medit.shard_filename(d, s) for d in dins]
            same_files(shard, label)
            same_files([medit.met_filename(x) for x in shard], label)
        st, _ = medit.load_mesh_distributed(
            dins[0], NPARTS, metpath=medit.met_filename(dins[0]),
            device="cuda")
        st = assign_global_ids(st)
        m = merge_shards(st, rebuild_comm(st))
        require_same_mesh(m, m_in, f"{label}: the mesh differs from the "
                          "one-process run's")
        print(f"## {label}: both ranks wrote the one-process per-rank "
              f"files ({int(m.ntet)} tets merged) bit for bit", flush=True)
    return out


def profile_distributed_path(n: int, cli_out) -> None:
    """Phase 2c, repeated: `adapt_distributed()` with the balanced CLI's
    options on the same input under torch.profiler, which must give the
    CLI's merged mesh `cli_out` bit for bit; device busy share and the
    kernels that take the time. Runs last: a capture of this size leaves
    later captures in the process without device records. Launch
    counters are not read here."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.models.distributed import (
        DistOptions, adapt_distributed, merge_adapted)

    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        mesh = medit.load_mesh(*write_graded_cube(work, n), device="cuda")
    # the CLI's -groups-ratio default is 2.0 (DistOptions' own is 2.5)
    opts = DistOptions(nparts=NPARTS, niter=NITER, grps_ratio=2.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, comm, info = adapt_distributed(mesh, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    merged = merge_adapted(st, comm)
    require_same_mesh(merged, cli_out, "the repeated distributed run "
                      "differs from the CLI's")
    fails = [r for r in info["history"] if "failure" in r]
    check_rollbacks([f"({r['error']}): {r['failure']}" for r in fails],
                    "the profiled distributed run")
    sweeps = [r for r in info["history"] if "failure" not in r]
    print(f"## repeat: adapt_distributed() under torch.profiler gave the "
          f"CLI's mesh ({int(merged.ntet)} tets) bit for bit; status "
          f"{int(info['status'])}, {len(sweeps)} sweeps, last shard_ne "
          f"{sweeps[-1]['shard_ne']}"
          + "".join(f"; it {r['iter']}: {r['error']}: {r['failure']}"
                    for r in fails)
          + "".join(f"; it {b['it']} rebalanced ({b['trigger']}, "
                    f"{b['cells']} cells, {b['wall_s']} s)"
                    for b in info["balance"]))
    _device_profile(prof, wall, "adapt_distributed under torch.profiler")


# phase 2g: the library API. The n=12 rung through `ParMesh`, loaded and
# staged, the shim driven by a C program of its own process, and
# ParMesh(nparts=4) on the graded cube for one iteration
API_WALL_S = 300


def capi_program(work: str) -> str:
    """Build `parmmg_tpu_torch/native/capi_example.c` against the port's
    C ABI shim (built first, at first use) with gcc. Returns the
    program's path."""
    from parmmg_tpu_torch import native

    exe = os.path.join(work, "capi_example")
    subprocess.run(["gcc", "-O2", "-o", exe,
                    os.path.join(native.NATIVE_DIR, "capi_example.c"),
                    native.capi_library()],
                   check=True, timeout=120)
    return exe


def check_result(m, what: str, ne_range=None):
    """Conforming, qmin > 0 and, given `ne_range`, ne inside it. Returns
    (ne, qmin)."""
    from parmmg_tpu_torch.ops import quality
    from parmmg_tpu_torch.utils import conformity

    rep = conformity.check_mesh(m)
    require(rep.ok, f"{what}: not conforming: {rep}")
    h = quality.quality_histogram(m)
    ne, qmin = int(h.ne), float(h.qmin)
    require(qmin > 0, f"{what}: qmin {qmin} <= 0")
    if ne_range is not None:
        require(ne_range[0] <= ne <= ne_range[1],
                f"{what}: ne {ne} outside {ne_range}")
    return ne, qmin


def api_path(n: int, hsiz: float, cli_mesh, cli_launches) -> None:
    """Phase 2g: the library API on the card (module docstring), each
    run with the launch counters set to 0 just before and read just
    after."""
    import numpy as np
    import torch

    from parmmg_tpu_torch import api, kernels
    from parmmg_tpu_torch.core.mesh import LEAVES, Mesh
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.utils import gen

    P, ok = api.Param, api.ReturnStatus.SUCCESS

    def rung(pm):
        pm.set_dparameter(P.DPARAM_hsiz, hsiz)
        pm.set_iparameter(P.IPARAM_niter, 1)
        pm.set_dparameter(P.DPARAM_hgrad, 0)
        return pm

    def run(pm, what):
        kernels.reset_launches()
        t0 = time.perf_counter()
        status = pm.parmmglib_centralized()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(status == ok, f"{what}: status {status!r} {pm.info}")
        launches = dict(kernels.LAUNCHES)
        print(f"## api {what}: SUCCESS in {wall:.3f} s, launches "
              f"{launches}", flush=True)
        return launches

    raw = gen.unit_cube(n)
    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        cube = os.path.join(work, f"cube{n}.mesh")
        medit.save_mesh(Mesh.from_numpy(raw["verts"], raw["tets"],
                                        trias=raw["trias"],
                                        trrefs=raw["trrefs"], device="cpu"),
                        cube)
        # the rung's input file, loaded
        pm = rung(api.ParMesh())
        pm.load_mesh(cube)
        loaded = pm.mesh.to_numpy_state()
        launches = run(pm, "ParMesh.load_mesh")
        require(launches == cli_launches, f"ParMesh.load_mesh launches "
                f"{launches}, the CLI's {cli_launches}")
        require_same_mesh(pm.mesh, cli_mesh, "ParMesh.load_mesh: the mesh "
                          "differs from the CLI's")
        print(f"## api ParMesh.load_mesh: the CLI's mesh "
              f"({int(cli_mesh.ntet)} tets) bit for bit and its launches")

        # the rung's arrays, staged
        pm_s = rung(api.ParMesh())
        pm_s.set_vertices(raw["verts"])
        pm_s.set_tetrahedra(raw["tets"])
        pm_s.set_triangles(raw["trias"], raw["trrefs"])
        staged = pm_s._build_mesh().to_numpy_state()
        same_in = all(np.array_equal(staged[k], loaded[k]) for k in LEAVES)
        launches_s = run(pm_s, "staged setters")
        for name in CENTRAL:
            require(launches_s[name] > 0, f"kernel {name} never launched "
                    "on the staged ParMesh run")
        ne, qmin = check_result(pm_s.mesh, "staged ParMesh", NE_RANGE)
        if same_in:
            require_same_mesh(pm_s.mesh, cli_mesh, "staged ParMesh: the "
                              "staged input equals the loaded one, the "
                              "output differs from the CLI's")
        print(f"## api staged setters: ne {ne} qmin {qmin:.6f}; staged "
              f"leaves {'equal' if same_in else 'differ from'} the CLI's "
              "loaded ones" + (", so the CLI's mesh bit for bit" if same_in
                               else ""))

        # the same buffers through the shim, from a C program
        verts = np.ascontiguousarray(raw["verts"], np.float64)
        for name, a in (("verts.f64", verts),
                        ("tets.i32", raw["tets"] + 1),
                        ("trias.i32", raw["trias"] + 1),
                        ("trrefs.i32", raw["trrefs"])):
            np.ascontiguousarray(a, a.dtype if a.dtype == np.float64
                                 else np.int32).tofile(
                os.path.join(work, name))
        t0 = time.perf_counter()
        exe = capi_program(work)
        t_build = time.perf_counter() - t0
        out = os.path.join(work, "capi_out.mesh")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in sys.path if p))
        t0 = time.perf_counter()
        r = subprocess.run(
            [exe, work, str(len(verts)), str(len(raw["tets"])),
             str(len(raw["trias"])), str(hsiz), "0", "1", cube, out],
            env=env, capture_output=True, text=True, timeout=API_WALL_S)
        print(r.stdout.strip())
        require(r.returncode == 0, f"capi_example exited {r.returncode}: "
                f"{r.stderr[-4000:]}")
        print(f"## api C program: built in {t_build:.2f} s, ran in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        def back(name, dt, cols=None):
            a = np.fromfile(os.path.join(work, name), dt)
            return a if cols is None else a.reshape(-1, cols)

        sizes = back("out_sizes.i32", np.int32)
        d = pm_s.mesh.to_numpy()
        require(tuple(sizes) == (len(d["verts"]), len(d["tets"]),
                                 len(d["trias"])),
                f"C program sizes {tuple(sizes)}")
        for name, dt, cols, want in (
                ("out_verts.f64", np.float64, 3, d["verts"]),
                ("out_vrefs.i32", np.int32, None, d["vrefs"]),
                ("out_met.f64", np.float64, 1, d["met"]),
                ("out_tets.i32", np.int32, 4, d["tets"] + 1),
                ("out_trefs.i32", np.int32, None, d["trefs"]),
                ("out_trias.i32", np.int32, 3, d["trias"] + 1),
                ("out_trrefs.i32", np.int32, None, d["trrefs"])):
            got = back(name, dt, cols)
            require(got.shape == want.shape and bool(
                (got == want.astype(dt)).all()),
                f"C program {name} differs from the staged ParMesh's")
        print("## api C program: the staged ParMesh's mesh bit for bit "
              f"({int(sizes[1])} tets)")
        ne, qmin = check_result(medit.load_mesh(out, device="cuda"),
                                "pmmgtpu_adapt_file")
        print(f"## api pmmgtpu_adapt_file: status 0, ne {ne} qmin "
              f"{qmin:.6f}, conforming")

        # four shards, one iteration, on the graded cube
        cube_g, sol = write_graded_cube(work, n)
        pm4 = api.ParMesh(nparts=NPARTS)
        pm4.set_iparameter(P.IPARAM_niter, 1)
        pm4.load_mesh(cube_g, sol)
        launches4 = run(pm4, f"ParMesh(nparts={NPARTS})")
        for name in kernels.NAMES:
            require(launches4[name] > 0, f"kernel {name} never launched "
                    f"on the ParMesh(nparts={NPARTS}) run")
        ne, qmin = check_result(pm4.mesh, f"ParMesh(nparts={NPARTS})")
        check_getters(pm4)
        print(f"## api ParMesh(nparts={NPARTS}): ne {ne} qmin {qmin:.6g}, "
              "conforming, getters consistent")


def check_getters(pm) -> None:
    """The distributed getters of a ParMesh's result, as
    tests/test_m6_api_io.py:571 checks them: every live vertex numbered,
    as many distinct ids as merged vertices; tria ids contiguous, as
    many as merged trias; each interface vertex owned by the lowest
    shard that holds it."""
    import numpy as np

    vg = np.concatenate(pm.get_vertex_glonum())
    require((vg >= 0).all() and len(np.unique(vg))
            == len(pm.get_vertices()[0]), "vertex global numbering")
    tg = np.concatenate(pm.get_triangle_glonum())
    real = tg[tg >= 0]
    require(len(real) > 0 and real.max() == len(np.unique(real)) - 1
            and len(np.unique(real)) == len(pm.get_triangles()[0]),
            "triangle global numbering")
    own = pm.get_node_communicator_owners()
    holders = {}
    for s, (rank, gid, nuni, ntot) in enumerate(own):
        require(ntot >= nuni > 0, f"owner counts {nuni}, {ntot}")
        for g in gid:
            holders.setdefault(int(g), []).append(s)
    for rank, gid, _, _ in own:
        require(all(r == min(holders[int(g)]) for r, g in zip(rank, gid)),
                "an interface vertex not owned by its lowest shard")


def levelset_path(n: int, hsiz: float) -> None:
    """Phase 2d: the level-set run. ls = |p - (0.5, 0.5, 0.5)| - LS_R,
    written as a .sol on the unit cube n^3, through the port's CLI with
    `-ls -sol sphere.sol -hsiz hsiz -niter 1 -hgrad 0 -out ls.vtu`,
    launch counters set to 0 just before and read just after; then
    `check_levelset_output`."""
    import numpy as np
    import torch

    from parmmg_tpu_torch import __main__ as cli
    from parmmg_tpu_torch import kernels
    from parmmg_tpu_torch.core.mesh import Mesh
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.utils import gen

    label = "level-set path"
    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        raw = gen.unit_cube(n)
        cube = os.path.join(work, f"cube{n}.mesh")
        sol = os.path.join(work, "sphere.sol")
        out = os.path.join(work, "ls.vtu")
        medit.save_mesh(Mesh.from_numpy(raw["verts"], raw["tets"],
                                        trias=raw["trias"],
                                        trrefs=raw["trrefs"], device="cpu"),
                        cube)
        ls = np.linalg.norm(raw["verts"] - 0.5, axis=1) - LS_R
        medit.save_sol(sol, ls[:, None], [medit.SOL_SCALAR])
        argv = [cube, "-ls", "-sol", sol, "-hsiz", str(hsiz), "-niter", "1",
                "-hgrad", "0", "-out", out]
        print(f"## {label}: python -m parmmg_tpu_torch {' '.join(argv)}",
              flush=True)
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        print(buf.getvalue())
        launch_report(label)
        require(rc == 0, f"CLI exited {rc}")
        for name in CENTRAL:
            require(launches[name] > 0, f"kernel {name} never launched on "
                    f"the {label}")
        print(f"## {label}: wall {wall:.3f} s, phases " + ", ".join(
            f"{k} {v:.3f} s" for k, v in phase_times(buf.getvalue()).items()))
        check_levelset_output(cube, sol, out, "cuda", label)


def check_levelset_output(cube: str, sol: str, out: str, device: str,
                          label: str) -> None:
    """The `.vtu` a `-ls -sol sol` run on the mesh `cube` wrote, reloaded
    with `load_vtu` on `device`, must be conforming with qmin > 0 and an
    element count in LS_NE_RANGE, carry ref-10 (isosurface) trias and an
    `ls` PointData array, and keep the ref-3 (inside) volume within
    LS_VOL_TOL of the discretized input's. Also checks CPU runs of
    either package (`device="cpu"`)."""
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch

    from parmmg_tpu_torch.io import medit, vtk
    from parmmg_tpu_torch.models.levelset import (REF_IN, REF_ISO,
                                                  discretize_levelset)
    from parmmg_tpu_torch.ops import quality
    from parmmg_tpu_torch.utils import conformity

    m = vtk.load_vtu(out, device=device)
    piece = ET.parse(out).getroot().find(".//Piece")
    names = [da.get("Name")
             for da in piece.find("PointData").iter("DataArray")]
    crefs = np.array(piece.find("CellData").find("DataArray").text.split(),
                     np.int64)
    # the discretized input, on the host from the files the CLI read
    d_in = discretize_levelset(medit.raw_to_mesh(
        medit.read_mesh(cube), ls=medit.read_sol(sol)[0][:, :1],
        dtype=torch.float64, device="cpu")).to_numpy()
    rep = conformity.check_mesh(m)
    require(rep.ok, f"{label}: output not conforming: {rep}")
    h = quality.quality_histogram(m)
    ne, qmin = int(h.ne), float(h.qmin)
    require(qmin > 0, f"{label}: qmin {qmin} <= 0")
    require(LS_NE_RANGE[0] <= ne <= LS_NE_RANGE[1],
            f"{label}: ne {ne} outside {LS_NE_RANGE}")
    d = m.to_numpy()
    trefs, trrefs = crefs[:len(d["tets"])], crefs[len(d["tets"]):]
    niso = int((trrefs == REF_ISO).sum())
    require(niso > 0, f"{label}: no ref-{REF_ISO} (isosurface) trias")
    require("ls" in names, f"{label}: no ls PointData array ({names})")

    def volume(verts, tets):
        c = verts.astype(np.float64)[tets]
        return float(np.einsum("ti,ti->t", np.cross(c[:, 1] - c[:, 0],
                                                    c[:, 2] - c[:, 0]),
                               c[:, 3] - c[:, 0]).sum() / 6.0)

    v_in = volume(d_in["verts"], d_in["tets"][d_in["trefs"] == REF_IN])
    v_out = volume(d["verts"], d["tets"][trefs == REF_IN])
    print(f"## {label}: ne {ne} np {int(m.npoin)} qmin {qmin:.6f} "
          f"qavg {float(h.qavg):.6f} conforming; {niso} ref-{REF_ISO} "
          f"trias; ref-{REF_IN} volume {v_out:.6f} against the discretized "
          f"input's {v_in:.6f} (|difference| {abs(v_out - v_in):.3g}, "
          f"bound {LS_VOL_TOL:.3g}); PointData {names}")
    require(abs(v_out - v_in) <= LS_VOL_TOL,
            f"{label}: ref-{REF_IN} volume {v_out} differs from the input's "
            f"{v_in} by more than {LS_VOL_TOL}")


def stream_fixture(m, N: int, P: int, dt, hsiz: float):
    """Tables and streams at (N, P) from the main path's mesh `m`: vert
    [P,3] of dtype `dt`, tet [N,4], a collapse-like retargeting new_tet
    (corner 0 of each row moved to corner 0 of the row before), and a
    split-like offset midpoint newp of edge (li, lj) of each row."""
    import numpy as np
    import torch

    from parmmg_tpu_torch.core.mesh import EDGE_VERTS
    from parmmg_tpu_torch.ops.common import take

    dev = m.device
    vert = fit_rows(m.vert, P, 0.0).to(dt)
    tet = fit_rows(m.tet, N, 0)
    new_tet = tet.clone()
    new_tet[:, 0] = tet.roll(1, 0)[:, 0]
    k6 = torch.as_tensor(np.arange(N) % 6, device=dev)
    ev = torch.as_tensor(EDGE_VERTS, dtype=torch.int64, device=dev)
    li, lj = ev[k6, 0].to(torch.int32), ev[k6, 1].to(torch.int32)
    rows = torch.arange(N, device=dev)
    noise = np.random.default_rng(3).normal(scale=0.3 * hsiz, size=(N, 3))
    c = take(vert, tet)
    newp = (0.5 * (c[rows, li.long()] + c[rows, lj.long()])
            + torch.as_tensor(noise, device=dev).to(dt)).contiguous()
    return vert, tet, new_tet, newp, li, lj


def metric(m, P: int, C: int, dt, hsiz: float):
    """The main path's iso sizes (C=1) or a seeded SPD field (C=6)."""
    return (fit_rows(m.met, P, 1.0).to(dt) if C == 1
            else spd_sym6(P, hsiz, dt, m.device))


def shard_source(m, D: int, P: int):
    """Shard 0 of the distributed path's merged output `m` cut into D
    shards by the port's partition, as a fixture source: its vertex and
    size tables cut or padded to P rows and its live tets whose vertices
    lie in those rows."""
    from types import SimpleNamespace

    from parmmg_tpu_torch.parallel import distribute, partition

    part = partition.sfc_partition(m, D).cpu().numpy()
    st, _ = distribute.split_mesh(m, part, D, build_shard_adjacency=False)
    ok = st.tmask[0] & (st.tet[0] < P).all(dim=1)
    return SimpleNamespace(vert=fit_rows(st.vert[0], P, 0.0),
                           met=fit_rows(st.met[0], P, 1.0),
                           tet=st.tet[0][ok].contiguous(), device=m.device)


def median_size(src) -> float:
    """The median iso size of a fixture source's live tets' corners."""
    return float(src.met[src.tet.reshape(-1).long(), 0].median())


def check_kernels(m, shapes: dict, hsiz: float, path: str,
                  names=CENTRAL) -> dict:
    """Phase 3: each kernel of `names` against its plain version on the
    card, at the (N stream rows, P table rows) of its own last launch on
    `path` (`shapes`), on tables and tets of `m` (a mesh, or a shard from
    `shard_source`), f32 and f64, C = 1 and 6; timed. Returns {(name,
    dtype, C): numbers}."""
    import torch

    from parmmg_tpu_torch import kernels
    from parmmg_tpu_torch.ops.common import POS_VOL_FRAC

    results = {}
    for dtn, dt in (("float32", torch.float32), ("float64", torch.float64)):
        isz = torch.finfo(dt).bits // 8
        for C in (1, 6):
            if "quality_vol" in names:
                N, P = shapes["quality_vol"]
                vert, tet, *_ = stream_fixture(m, N, P, dt, hsiz)
                met = metric(m, P, C, dt, hsiz)
                s_vol, s_q = row_scales(vert, met, tet)
                q, vol = kernels.quality_vol(vert, met, tet)
                q0, vol0 = kernels.quality_vol_plain(vert, met, tet)
                err = max(
                    check_close(q, q0, s_q, dtn,
                                f"quality_vol q {dtn} C={C}"),
                    check_close(vol, vol0, s_vol, dtn,
                                f"quality_vol vol {dtn} C={C}"))
                results[("quality_vol", dtn, C)] = timed(
                    "quality_vol",
                    lambda: kernels.quality_vol(vert, met, tet),
                    lambda: kernels.quality_vol_plain(vert, met, tet),
                    err, *bound("quality_vol", C, P, N, isz, dtn))

            if "collapse_cavity" in names:
                N, P = shapes["collapse_cavity"]
                vert, tet, new_tet, *_ = stream_fixture(m, N, P, dt, hsiz)
                met = metric(m, P, C, dt, hsiz)
                vol0 = kernels.quality_vol_plain(vert, met, tet)[1]
                floor = (POS_VOL_FRAC * vol0.abs()).contiguous()
                g = kernels.collapse_cavity(vert, met, new_tet, floor)
                g0 = kernels.collapse_cavity_plain(vert, met, new_tet,
                                                   floor)
                require(torch.equal(torch.isinf(g), torch.isinf(g0)),
                        f"collapse_cavity -inf positions differ ({dtn} "
                        f"C={C})")
                fin = torch.isfinite(g0)
                require(0 < int(fin.sum()) < N,
                        "collapse_cavity fixture has no mix of gates")
                err = check_close(g[fin], g0[fin],
                                  row_scales(vert, met, new_tet)[1][fin],
                                  dtn, f"collapse_cavity {dtn} C={C}")
                results[("collapse_cavity", dtn, C)] = timed(
                    "collapse_cavity",
                    lambda: kernels.collapse_cavity(vert, met, new_tet,
                                                    floor),
                    lambda: kernels.collapse_cavity_plain(vert, met,
                                                          new_tet, floor),
                    err, *bound("collapse_cavity", C, P, N, isz, dtn))

        if "split_midpoint" in names:
            N, P = shapes["split_midpoint"]
            vert, tet, _, newp, li, lj = stream_fixture(m, N, P, dt,
                                                        hsiz)
            ok = kernels.split_midpoint(vert, tet, newp, li, lj)
            ok0 = kernels.split_midpoint_plain(vert, tet, newp, li, lj)
            require(torch.equal(ok, ok0),
                    f"split_midpoint booleans differ ({dtn})")
            require(0 < int(ok0.sum()) < N,
                    "split_midpoint fixture has no mix of verdicts")
            results[("split_midpoint", dtn, 0)] = timed(
                "split_midpoint",
                lambda: kernels.split_midpoint(vert, tet, newp, li, lj),
                lambda: kernels.split_midpoint_plain(vert, tet, newp, li,
                                                     lj),
                0.0, *bound("split_midpoint", 0, P, N, isz, dtn))
            results[("split_midpoint", dtn, 0)]["launch_floor_ms"] = \
                launch_floor(N, 1)
    for (name, dtn, C), r in results.items():
        N, P = shapes[name]
        print(f"## kernel {name} {dtn} C={C} P={P} N={N} ({path}): device "
              f"{r['ms']:.4f} ms (per call {r['call_ms']:.4f} ms), plain "
              f"device {r['plain_ms']:.4f} ms (per call "
              f"{r['plain_call_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f} % of "
              f"it), max|err| {r['err']:.3e}")
        print(floors(name, dtn, C, N, r))
    return results


def interp_fixture(m, shapes, dt):
    """interp_bary's inputs at the (Q rows, P table rows, D shards) of its
    last launch on the distributed path, from the merged output `m` cut
    into D shards by the port's partition: each shard's vertex and size
    tables, its tets cycled to Q rows, and seeded points around them
    (barycentric weights in [-0.1, 1.1], so some fall outside their tet
    and take the clamp)."""
    import numpy as np
    import torch

    from parmmg_tpu_torch.ops.common import take
    from parmmg_tpu_torch.parallel import distribute, partition

    Q, P, D = shapes["interp_bary"]
    part = partition.sfc_partition(m, D).cpu().numpy()
    st, _ = distribute.split_mesh(m, part, D, build_shard_adjacency=False)
    rng = np.random.default_rng(11)
    verts, mets, vids, pts = [], [], [], []
    for s in range(D):
        v = fit_rows(st.vert[s], P, 0.0).to(dt)
        # live tets whose vertices lie in the first P table rows
        ok = st.tmask[s] & (st.tet[s] < P).all(dim=1)
        live = torch.nonzero(ok).reshape(-1)
        tet = st.tet[s][live[torch.arange(Q, device=live.device)
                             % live.numel()]].to(torch.int32).contiguous()
        w = torch.as_tensor(rng.uniform(-0.1, 1.1, size=(Q, 4)),
                            device=v.device).to(dt)
        w = w / w.sum(1, keepdim=True)
        verts.append(v)
        mets.append(fit_rows(st.met[s], P, 1.0).to(dt))
        vids.append(tet)
        pts.append((w[:, :, None] * take(v, tet)).sum(1))
    return (torch.stack(verts), torch.stack(mets), torch.stack(vids),
            torch.stack(pts).contiguous())


def check_interp(m, shapes) -> dict:
    """Phase 3 for interp_bary: the kernel against its plain version on
    the card at the shapes of its last launch on the distributed path,
    f32 and f64, C = 1 (C = 6 takes the plain version in the wrapper);
    timed. Returns {("interp_bary", dtype, 1): numbers}."""
    import torch

    from parmmg_tpu_torch import kernels

    results = {}
    Q, P, D = shapes["interp_bary"]
    for dtn, dt in (("float32", torch.float32), ("float64", torch.float64)):
        isz = torch.finfo(dt).bits // 8
        vert, met, vids, pts = interp_fixture(m, shapes, dt)
        b, mq = kernels.interp_bary(vert, met, vids, pts)
        b0, mq0 = kernels.interp_bary_plain(vert, met, vids, pts)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(b0).all()),
                "interp_bary fixture has degenerate rows")
        clamped = int((b0 == 0).any(-1).sum())
        require(0 < clamped < D * Q, "interp_bary fixture has no mix of "
                "inside and clamped points")
        err = max(
            check_close(b, b0, torch.ones_like(b0), dtn,
                        f"interp_bary bary {dtn}"),
            check_close(mq, mq0, torch.zeros_like(mq0), dtn,
                        f"interp_bary met_q {dtn}"))
        results[("interp_bary", dtn, 1)] = timed(
            "interp_bary",
            lambda: kernels.interp_bary(vert, met, vids, pts),
            lambda: kernels.interp_bary_plain(vert, met, vids, pts),
            err, *bound("interp_bary", 1, D * P, D * Q, isz, dtn))
        r = results[("interp_bary", dtn, 1)]
        r["launch_floor_ms"] = launch_floor(Q, D)
        same = bool(torch.equal(b, b0) and torch.equal(mq, mq0))
        print(f"## kernel interp_bary {dtn} C=1 D={D} P={P} Q={Q}: device "
              f"{r['ms']:.4f} ms (per call {r['call_ms']:.4f} ms), plain "
              f"device {r['plain_ms']:.4f} ms (per call "
              f"{r['plain_call_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f} % of "
              f"it), max|err| {r['err']:.3e}, "
              f"bit for bit: {same}, {clamped} of {D * Q} rows clamped")
        print(floors("interp_bary", dtn, 1, D * Q, r))
        require(same, f"interp_bary {dtn}: the kernel's bary or met_q "
                "differ from the plain version's in bits")
    return results


def _history(info):
    keys = ("nsplit", "ncollapse", "nswap", "nmoved", "ne", "np", "error")
    return [tuple(r.get(k) for k in keys) + (tuple(r.get("shard_ne", ())),)
            for r in info["history"]] + [
        (b["it"], b["trigger"], b["cells"], b["imbalance_post"])
        for b in info.get("balance", ())]


@contextlib.contextmanager
def counting_reads(on: bool):
    """With `on`, make every device-to-host read inside the drivers'
    sweep loops (`run_sweep_loop`, shared by both drivers) a warning."""
    import torch

    from parmmg_tpu_torch.models import adapt as adapt_mod
    from parmmg_tpu_torch.models import distributed as dist_mod

    real = adapt_mod.run_sweep_loop

    def loop(*a, **kw):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    if on:
        adapt_mod.run_sweep_loop = dist_mod.run_sweep_loop = loop
    try:
        yield
    finally:
        adapt_mod.run_sweep_loop = dist_mod.run_sweep_loop = real


def small_f64_runs() -> None:
    """Phase 4: unit cube n=4 at f64 on the card and on the CPU, through
    `adapt()` and through `adapt_distributed()` on 2 shards with
    -nobalance, each with frontier and with full-table sweeps, balanced
    with frontier sweeps carrying the linear field, `adapt()` of the
    cube split along a sphere (`discretize_levelset`) carrying the
    linear field, `adapt_stacked_input()` on the cube's 2 per-rank
    binary files with the communicator checks (balanced), and `adapt()`
    after `renumber_sfc` (`-rn`): the per-sweep histories (with the
    rebalancings) must be equal, the balanced one also to a field-less
    CPU run's, and the level-set run's ls and fields within RTOL of the
    CPU's; then the per-rank run is timed on the card without and with
    the communicator checks."""
    import numpy as np
    import torch

    from parmmg_tpu_torch.core.adjacency import build_adjacency
    from parmmg_tpu_torch.core.mesh import Mesh
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.models.adapt import AdaptOptions, adapt
    from parmmg_tpu_torch.models.distributed import (
        DistOptions, adapt_distributed, adapt_stacked_input, merge_adapted)
    from parmmg_tpu_torch.models.levelset import discretize_levelset
    from parmmg_tpu_torch.parallel.distribute import split_mesh
    from parmmg_tpu_torch.parallel.partition import (renumber_sfc,
                                                     sfc_partition)
    from parmmg_tpu_torch.utils import conformity, gen

    def cube(d, field=False):
        m = gen.unit_cube_mesh(4, dtype=torch.float64, device=d)
        if not field:
            return m
        return m.replace(fields=torch.as_tensor(
            linear_fields(m.vert.cpu().numpy()), device=d),
            field_ncomp=(1, 3))

    def sphere(d):
        raw = gen.unit_cube(4)
        v = raw["verts"]
        return discretize_levelset(Mesh.from_numpy(
            v, raw["tets"], trias=raw["trias"], trrefs=raw["trrefs"],
            ls=(np.linalg.norm(v - 0.5, axis=1) - LS_R)[:, None],
            fields=linear_fields(v), field_ncomp=(1, 3),
            dtype=torch.float64, device=d))

    def loaded(d):
        # the cube's Morton split on 2 shards as binary per-rank files,
        # loaded back on `d`
        m = build_adjacency(cube("cpu"))
        st, comm = split_mesh(m, sfc_partition(m, 2).numpy(), 2)
        with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
            path = os.path.join(work, "in.meshb")
            medit.save_mesh_distributed(st, comm, path)
            return medit.load_mesh_distributed(
                path, 2, dtype=torch.float64, device=d)

    def renumbered(d):
        return build_adjacency(renumber_sfc(cube(d)))

    runs = {}
    for fr in (True, False):
        sweeps = "frontier" if fr else "full-table"
        runs[f"centralized {sweeps}"] = cube, lambda m, d, fr=fr: adapt(
            m, AdaptOptions(hsiz=0.18, niter=1, max_sweeps=6, hgrad=None,
                            frontier=fr), device=d)
        runs[f"distributed {sweeps}"] = cube, lambda m, d, fr=fr: \
            adapt_distributed(m, DistOptions(
                hsiz=0.18, niter=2, max_sweeps=6, hgrad=None, nparts=2,
                nobalancing=True, min_shard_elts=16, frontier=fr), device=d)

    def balanced(m, d):
        return adapt_distributed(m, DistOptions(
            hsiz=0.18, niter=2, max_sweeps=6, hgrad=None, nparts=2,
            min_shard_elts=16), device=d)

    runs["distributed balanced -field"] = (
        lambda d: cube(d, field=True), balanced)
    def stacked_input(st, d, check=True):
        return adapt_stacked_input(*st, DistOptions(
            hsiz=0.18, niter=2, max_sweeps=6, hgrad=None,
            check_comm=check), device=d)

    runs["-distributed-input check_comm"] = loaded, stacked_input
    runs["centralized -rn"] = renumbered, lambda m, d: adapt(
        m, AdaptOptions(hsiz=0.18, niter=1, max_sweeps=6, hgrad=None),
        device=d)
    runs["centralized -ls -field"] = sphere, lambda m, d: adapt(
        m, AdaptOptions(hsiz=0.2, niter=1, max_sweeps=6, hgrad=None),
        device=d)
    threads = torch.get_num_threads()
    for label, (make, run) in runs.items():
        hist, sols = {}, {}
        for d in ("cuda", "cpu"):
            # one host thread: at these sizes more only add synchronisation
            torch.set_num_threads(1 if d == "cpu" else threads)
            mesh = make(d)
            with warnings.catch_warnings(record=True) as caught:
                # every device-to-host read of the sweep loops, as warnings
                warnings.simplefilter("always")
                with counting_reads(d == "cuda"):
                    out = run(mesh, d)
            mm = out[0] if len(out) == 2 else merge_adapted(out[0], out[1])
            require(conformity.check_mesh(mm).ok,
                    f"f64 {label} run on {d} not conforming")
            hist[d] = _history(out[-1])
            sols[d] = torch.cat([mm.ls, mm.fields], 1)[mm.vmask].cpu()
            print(f"## f64 n=4 {label} on {d}: ne {int(mm.ntet)} status "
                  f"{int(out[-1]['status'])} history {hist[d]}")
            if d == "cuda":
                reads = sum("synchroniz" in str(w.message) for w in caught)
                print(f"## f64 n=4 {label}: {reads} host reads in the sweep "
                      f"loops, {reads / len(hist[d]):.1f} a sweep record")
        first = next((i for i, (a, b) in enumerate(zip(hist["cuda"],
                                                       hist["cpu"]))
                      if a != b), None)
        require(hist["cuda"] == hist["cpu"],
                f"f64 {label} run: the card's per-sweep history differs "
                f"from the CPU's (first at sweep record {first})")
        if "-field" not in label:
            continue
        a, b = sols["cuda"], sols["cpu"]
        require(a.shape == b.shape and a.shape[1] > 0 and bool(
            ((a - b).abs() <= RTOL["float64"] * b.abs().clamp(min=1)).all()),
                f"f64 {label} run: the card's ls/fields differ from the "
                f"CPU's beyond {RTOL['float64']}")
        if label.startswith("distributed balanced"):
            # the field enters no decision: the same run without it, on
            # the CPU, has the same history
            torch.set_num_threads(1)
            require(_history(balanced(cube("cpu"), "cpu")[-1])
                    == hist["cpu"], f"f64 {label} run: the history "
                    "differs from the field-less run's")
            print(f"## f64 n=4 {label}: the field-less run's history")
    torch.set_num_threads(threads)
    # what the communicator checks cost: the -distributed-input run on the
    # card without and with them, alternated, each timed whole
    walls = {False: [], True: []}
    for check in (False, True, False, True):
        st = loaded("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stacked_input(st, "cuda", check)
        torch.cuda.synchronize()
        walls[check].append(time.perf_counter() - t1)
    print("## f64 n=4 -distributed-input on cuda, wall without check_comm "
          + ", ".join(f"{w:.3f}" for w in walls[False]) + " s, with "
          + ", ".join(f"{w:.3f}" for w in walls[True]) + " s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from parmmg_tpu_torch import kernels

    card = gpu_line()
    print(f"## card: {card}", flush=True)
    build_kernels()
    t0 = time.perf_counter()
    m, launches, shapes = main_path(CUBE_N, HSIZ, NE_RANGE)
    same_run(m, launches, "main path",
             *main_path(CUBE_N, HSIZ, NE_RANGE, fields=True)[:2])
    profile_main_path(CUBE_N, HSIZ, m)
    main_path(CUBE_N, HSIZ, NE_RANGE, extra=("-nofrontier",),
              expect=NOFRONTIER_MESH)
    levelset_path(CUBE_N, HSIZ)
    print(f"## phase 2 done at {time.perf_counter() - t0:.1f} s", flush=True)
    t2g = time.perf_counter()
    api_path(CUBE_N, HSIZ, m, launches)
    print(f"## phase 2g done at {time.perf_counter() - t0:.1f} s "
          f"({time.perf_counter() - t2g:.1f} s)", flush=True)
    m_d, launches_d, shapes_d = distributed_path(CUBE_N, DIST_NE_RANGE)
    same_run(m_d, launches_d, "distributed path",
             *distributed_path(CUBE_N, DIST_NE_RANGE, fields=True)[:2])
    for extra in (("-nobalance",), ("-nobalance", "-nofrontier")):
        distributed_path(CUBE_N, DIST_NE_RANGE, extra=extra,
                         expect_ne=DIST_NOBALANCE_NE)
    print(f"## phase 2c done at {time.perf_counter() - t0:.1f} s", flush=True)
    m_in, _, shapes_in, q_in = distributed_input_path(CUBE_N, DIST_NE_RANGE)
    print(f"## phase 2e done at {time.perf_counter() - t0:.1f} s", flush=True)
    two_rank_path(CUBE_N, m_d, m_in, card)
    print(f"## phase 2f done at {time.perf_counter() - t0:.1f} s", flush=True)
    results = check_kernels(m, shapes, HSIZ, "centralized")
    # the same kernels at the per-shard shapes of the balanced distributed
    # path: a rolled-back iteration can leave the run's last launches on
    # tables of different capacities, so the fixture source's tets index
    # only the smallest table and each kernel's table is padded to its own
    p_d = min(shapes_d[k][1] for k in CENTRAL)
    print(f"## distributed path: last launches (N, P) {shapes_d}")
    src = shard_source(m_d, NPARTS, p_d)
    check_kernels(src, shapes_d, median_size(src), "distributed")
    results.update(check_interp(m_d, shapes_d))
    # and at those of the distributed-input path (2e), whose rolled-back
    # iteration need not match the balanced path's, with quality_vol
    # also at its smallest launch there: a shard's input histogram
    p_in = min([shapes_in[k][1] for k in CENTRAL] + [q_in[1]])
    print(f"## distributed input: last launches (N, P) {shapes_in}, "
          f"input histogram {q_in}")
    src = shard_source(m_in, NPARTS, p_in)
    check_kernels(src, shapes_in, median_size(src), "distributed input")
    check_kernels(src, {"quality_vol": q_in}, median_size(src),
                  "distributed input histogram", names=("quality_vol",))
    check_interp(m_in, shapes_in)
    print(f"## phase 3 done at {time.perf_counter() - t0:.1f} s", flush=True)
    small_f64_runs()
    print(f"## phase 4 done at {time.perf_counter() - t0:.1f} s", flush=True)
    profile_distributed_path(CUBE_N, m_d)
    print(f"## phase 2c repeat done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    line = {"kernels": []}
    for name in kernels.NAMES:
        r = results[(name, "float32", 0 if name == "split_midpoint" else 1)]
        line["kernels"].append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name],
            launches=(launches if name in CENTRAL else launches_d)[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None,
        ))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
