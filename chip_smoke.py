#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`parmmg_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit and PyTorch built for CUDA. Phases, each raising on failure:

1. print the card (`nvidia-smi` name and power limit) and build the CUDA
   kernels of `parmmg_tpu_torch/csrc/` (one `nvcc` per source, all
   started together, linked into one library);
2. centralized path: write the structured unit cube 12^3 with the port's
   Medit writer and run the port's CLI on it (`-hsiz 0.04 -niter 1 -hgrad
   0`, the n12-hsiz0.04 rung of bench.py), with every kernel launch
   counter set to 0 just before and read just after; reload the output
   and check conformity, qmin > 0 and the element count; then the same
   adaptation once more through `adapt()` under torch.profiler, which
   must give the CLI's mesh bit for bit, for the device busy share and
   the kernels that take the time;
2c. distributed path: the same cube with the graded iso size
   h = 0.025 + 0.05 x written as a .sol, through the CLI with `-nparts 4
   -nobalance` (f32, niter 3, hgrad 1.3, -ar 45), counters set to 0 just
   before and read just after: interp_bary must launch at least niter
   times and the other kernels at least once; an iteration may be rolled
   back only on the phase-boundary validation; the merged output must be
   conforming with qmin > 0 and an element count in a window around the
   JAX package's count for the same command on a CPU; at the end of the
   script, `adapt_distributed()` again under torch.profiler, which must
   give the CLI's mesh bit for bit;
3. every kernel against its plain PyTorch version on the card, at the
   shapes of its own last launch on each path it runs on (tables of P
   rows, a stream of N rows; the three sweep kernels at the centralized
   shapes on the output of 2, and at the per-shard shapes of 2c on a
   shard of the merged output of 2c; interp_bary over D shards of that
   output) in f32 and f64, with iso (C=1)
   and seeded SPD tensor (C=6) metrics where the kernel takes them;
   timed on the device (CUPTI records through torch.profiler) and per
   call (CUDA events), medians over 25 runs after a warm-up;
4. small f64 adaptations on the card against the same runs on the CPU,
   centralized and distributed: the per-sweep histories must be equal;
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
import statistics
import subprocess
import sys
import tempfile
import time

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
# window its output must fall in (BASELINE.md: 201,001 tets on a CPU,
# 211,264 on a TPU for the JAX package)
CUBE_N, HSIZ = 12, 0.04
NE_RANGE = (180_000, 240_000)

# the distributed path: graded iso size h = H0 + H1 x on the same cube,
# NPARTS shards, the CLI's defaults (niter 3, hgrad 1.3, -ar 45, f32);
# the JAX package's CLI on a CPU gives 148,506 tets for this command
# (with -nofrontier; PERF.md), the window is about 15 % either side
GRADED_H = (0.025, 0.05)
NPARTS, NITER = 4, 3
DIST_NE_RANGE = (126_000, 171_000)

# float agreement band of tests/test_m18_kernels.py `_rtol`
RTOL = {"float32": 5e-6, "float64": 5e-11}

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


def time_ms(fn, reps: int = 25, warm: int = 3):
    """(device ms, call ms) of one call of `fn`, medians over `reps`.

    Device ms: the GPU time of the kernels the call launched, read from
    `torch.profiler` (CUPTI) records — the per-call CUDA-event time is
    dominated by the host's launch overhead at these sizes. Call ms:
    CUDA-event time around each call. Where the profiler records no
    device activity, device ms is None."""
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    dev_ms = dev_us / reps / 1e3 if dev_us > 0 else None
    return dev_ms, statistics.median(calls)


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


def timed(fn, fn0, err, bound_ms, bound_by) -> dict:
    """Times of a kernel `fn` and its plain version `fn0`: device time
    (CUPTI) where the profiler saw the kernels, else CUDA-event time."""
    dev, call = time_ms(fn)
    dev0, call0 = time_ms(fn0)
    if dev is None or dev0 is None:
        print("## note: the profiler recorded no device activity; kernel "
              "times are CUDA-event times per call")
        dev, dev0 = call, call0
    return dict(ms=dev, call_ms=call, plain_ms=dev0, plain_call_ms=call0,
                err=err, bound_ms=bound_ms, bound_by=bound_by)


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


def build_kernels() -> None:
    """Phase 1: one nvcc per kernel source, all started together, then
    one link into the kernel library."""
    from parmmg_tpu_torch import kernels

    build_s = kernels.build_all()
    print(f"## build: {len(kernels.NAMES)} CUDA kernels in {build_s:.2f} s")
    for name, log in kernels.build.BUILD_LOGS.items():
        for ln in log.splitlines():
            if "registers" in ln:
                print(f"   {name}: {ln.strip()}")


def main_path(n: int, hsiz: float, ne_range):
    """Phase 2: the port's CLI on the unit cube n^3, launch counters set
    to 0 just before and read just after. Returns (output mesh on the
    card, launches, shapes of each kernel's last launch)."""
    import torch

    from parmmg_tpu_torch import __main__ as cli
    from parmmg_tpu_torch import kernels
    from parmmg_tpu_torch.core.mesh import Mesh
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.ops import quality
    from parmmg_tpu_torch.utils import conformity, gen

    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        cube = os.path.join(work, f"cube{n}.mesh")
        out = os.path.join(work, "out.mesh")
        raw = gen.unit_cube(n)
        medit.save_mesh(Mesh.from_numpy(raw["verts"], raw["tets"],
                                        trias=raw["trias"],
                                        trrefs=raw["trrefs"], device="cpu"),
                        cube)
        argv = [cube, "-hsiz", str(hsiz), "-niter", "1", "-hgrad", "0",
                "-out", out]
        print(f"## main path: python -m parmmg_tpu_torch {' '.join(argv)}",
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
        require(rc == 0, f"CLI exited {rc}")
        m = medit.load_mesh(out, medit.met_filename(out), device="cuda")
    # a wrapper launches its kernel only for CUDA tensors: every counter
    # above 0 shows the main path's mesh lived on the card
    for name in CENTRAL:
        require(launches[name] > 0, f"kernel {name} never launched on the "
                "main path")
    rep = conformity.check_mesh(m)
    require(rep.ok, f"output mesh not conforming: {rep}")
    h = quality.quality_histogram(m)
    ne, qmin, qavg = int(h.ne), float(h.qmin), float(h.qavg)
    in_band = quality.in_band_fraction(quality.mesh_length_stats(m))
    require(qmin > 0, f"qmin {qmin} <= 0")
    require(ne_range[0] <= ne <= ne_range[1], f"ne {ne} outside {ne_range}")
    print(f"## main path: wall {wall:.3f} s, phases " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phase_times(buf.getvalue()).items()))
    print(f"## main path: ne {ne} np {int(m.npoin)} qmin {qmin:.6f} "
          f"qavg {qavg:.6f} in_band {in_band:.6f} conforming")
    print("## main path launches: " + ", ".join(
        f"{k} {launches[k]} (last at N={shapes[k][0]}, P={shapes[k][1]})"
        for k in CENTRAL) + f"; interp_bary {launches['interp_bary']}")
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
    a, b = out.to_numpy(), cli_out.to_numpy()
    for k in ("verts", "tets", "trias", "met"):
        require(a[k].shape == b[k].shape
                and bool((a[k].astype(b[k].dtype) == b[k]).all()),
                f"the repeated adaptation differs from the CLI's ({k})")
    print(f"## repeat: adapt() under torch.profiler gave the CLI's mesh "
          f"({len(a['tets'])} tets) bit for bit")
    _device_profile(prof, wall, "adapt under torch.profiler")


def _device_profile(prof, wall: float, label: str) -> None:
    """Print the device busy share of `wall` and the top device kernels
    of a torch.profiler capture."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = _short(e.name)
        us, cnt = by_name.get(k, (0.0, 0))
        by_name[k] = (us + e.time_range.elapsed_us(), cnt + 1)
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


def distributed_path(n: int, ne_range):
    """Phase 2c: the port's CLI with `-nparts NPARTS -nobalance` on the
    graded cube, launch counters set to 0 just before and read just
    after. Returns (merged output mesh on the card, launches, shapes)."""
    import torch

    from parmmg_tpu_torch import __main__ as cli
    from parmmg_tpu_torch import kernels
    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.ops import quality
    from parmmg_tpu_torch.utils import conformity

    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        cube, sol = write_graded_cube(work, n)
        out = os.path.join(work, "dist.mesh")
        argv = [cube, "-sol", sol, "-nparts", str(NPARTS), "-nobalance",
                "-niter", str(NITER), "-out", out]
        print(f"## distributed path: python -m parmmg_tpu_torch "
              f"{' '.join(argv)}", flush=True)
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, shapes = dict(kernels.LAUNCHES), dict(kernels.SHAPES)
        print(buf.getvalue())
        require(rc == 0, f"CLI exited {rc}")
        m = medit.load_mesh(out, medit.met_filename(out), device="cuda")
    check_rollbacks([ln for ln in buf.getvalue().splitlines()
                     if "rolled back" in ln], "the distributed CLI")
    require(launches["interp_bary"] >= NITER,
            f"interp_bary launched {launches['interp_bary']} times on the "
            f"distributed path, fewer than niter={NITER}")
    for name in kernels.NAMES:
        require(launches[name] > 0, f"kernel {name} never launched on the "
                "distributed path")
    rep = conformity.check_mesh(m)
    require(rep.ok, f"merged output not conforming: {rep}")
    h = quality.quality_histogram(m)
    ne, qmin = int(h.ne), float(h.qmin)
    require(qmin > 0, f"distributed qmin {qmin} <= 0")
    require(ne_range[0] <= ne <= ne_range[1],
            f"distributed ne {ne} outside {ne_range}")
    in_band = quality.in_band_fraction(quality.mesh_length_stats(m))
    print(f"## distributed path: wall {wall:.3f} s, phases " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phase_times(buf.getvalue()).items()))
    print(f"## distributed path: ne {ne} np {int(m.npoin)} qmin {qmin:.6g} "
          f"qavg {float(h.qavg):.6f} in_band {in_band:.6f} conforming")
    print("## distributed path launches: " + ", ".join(
        f"{k} {launches[k]} (last at {shapes.get(k)})"
        for k in kernels.NAMES))
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


def profile_distributed_path(n: int, cli_out) -> None:
    """Phase 2c, repeated: `adapt_distributed()` on the same input under
    torch.profiler, which must give the CLI's merged mesh `cli_out` bit
    for bit; device busy share and the kernels that take the time. Runs
    last: a capture of this size leaves later captures in the process
    without device records. Launch counters are not read here."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from parmmg_tpu_torch.io import medit
    from parmmg_tpu_torch.models.distributed import (
        DistOptions, adapt_distributed, merge_adapted)

    with tempfile.TemporaryDirectory(prefix="pmt_smoke_") as work:
        mesh = medit.load_mesh(*write_graded_cube(work, n), device="cuda")
    opts = DistOptions(nparts=NPARTS, nobalancing=True, niter=NITER)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, comm, info = adapt_distributed(mesh, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    a, b = merge_adapted(st, comm).to_numpy(), cli_out.to_numpy()
    for k in ("verts", "tets", "trias", "met"):
        require(a[k].shape == b[k].shape
                and bool((a[k].astype(b[k].dtype) == b[k]).all()),
                f"the repeated distributed run differs from the CLI's ({k})")
    fails = [r for r in info["history"] if "failure" in r]
    check_rollbacks([f"({r['error']}): {r['failure']}" for r in fails],
                    "the profiled distributed run")
    sweeps = [r for r in info["history"] if "failure" not in r]
    print(f"## repeat: adapt_distributed() under torch.profiler gave the "
          f"CLI's mesh ({len(a['tets'])} tets) bit for bit; status "
          f"{int(info['status'])}, {len(sweeps)} sweeps, last shard_ne "
          f"{sweeps[-1]['shard_ne']}"
          + "".join(f"; it {r['iter']}: {r['error']}: {r['failure']}"
                    for r in fails))
    _device_profile(prof, wall, "adapt_distributed under torch.profiler")


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


def check_kernels(m, shapes: dict, hsiz: float, path: str) -> dict:
    """Phase 3: each kernel against its plain version on the card, at the
    (N stream rows, P table rows) of its own last launch on `path`
    (`shapes`), on tables and tets of `m` (a mesh, or a shard from
    `shard_source`), f32 and f64, C = 1 and 6; timed. Returns {(name,
    dtype, C): numbers}."""
    import torch

    from parmmg_tpu_torch import kernels
    from parmmg_tpu_torch.ops.common import POS_VOL_FRAC

    results = {}
    for dtn, dt in (("float32", torch.float32), ("float64", torch.float64)):
        isz = torch.finfo(dt).bits // 8
        for C in (1, 6):
            N, P = shapes["quality_vol"]
            vert, tet, *_ = stream_fixture(m, N, P, dt, hsiz)
            met = metric(m, P, C, dt, hsiz)
            s_vol, s_q = row_scales(vert, met, tet)
            q, vol = kernels.quality_vol(vert, met, tet)
            q0, vol0 = kernels.quality_vol_plain(vert, met, tet)
            err = max(
                check_close(q, q0, s_q, dtn, f"quality_vol q {dtn} C={C}"),
                check_close(vol, vol0, s_vol, dtn,
                            f"quality_vol vol {dtn} C={C}"))
            results[("quality_vol", dtn, C)] = timed(
                lambda: kernels.quality_vol(vert, met, tet),
                lambda: kernels.quality_vol_plain(vert, met, tet),
                err, *bound("quality_vol", C, P, N, isz, dtn))

            N, P = shapes["collapse_cavity"]
            vert, tet, new_tet, *_ = stream_fixture(m, N, P, dt, hsiz)
            met = metric(m, P, C, dt, hsiz)
            floor = (POS_VOL_FRAC
                     * kernels.quality_vol_plain(vert, met, tet)[1].abs()
                     ).contiguous()
            g = kernels.collapse_cavity(vert, met, new_tet, floor)
            g0 = kernels.collapse_cavity_plain(vert, met, new_tet, floor)
            require(torch.equal(torch.isinf(g), torch.isinf(g0)),
                    f"collapse_cavity -inf positions differ ({dtn} C={C})")
            fin = torch.isfinite(g0)
            require(0 < int(fin.sum()) < N,
                    "collapse_cavity fixture has no mix of gates")
            err = check_close(g[fin], g0[fin],
                              row_scales(vert, met, new_tet)[1][fin], dtn,
                              f"collapse_cavity {dtn} C={C}")
            results[("collapse_cavity", dtn, C)] = timed(
                lambda: kernels.collapse_cavity(vert, met, new_tet, floor),
                lambda: kernels.collapse_cavity_plain(vert, met, new_tet,
                                                      floor),
                err, *bound("collapse_cavity", C, P, N, isz, dtn))

        N, P = shapes["split_midpoint"]
        vert, tet, _, newp, li, lj = stream_fixture(m, N, P, dt, hsiz)
        ok = kernels.split_midpoint(vert, tet, newp, li, lj)
        ok0 = kernels.split_midpoint_plain(vert, tet, newp, li, lj)
        require(torch.equal(ok, ok0),
                f"split_midpoint booleans differ ({dtn})")
        require(0 < int(ok0.sum()) < N,
                "split_midpoint fixture has no mix of verdicts")
        results[("split_midpoint", dtn, 0)] = timed(
            lambda: kernels.split_midpoint(vert, tet, newp, li, lj),
            lambda: kernels.split_midpoint_plain(vert, tet, newp, li, lj),
            0.0, *bound("split_midpoint", 0, P, N, isz, dtn))
    for (name, dtn, C), r in results.items():
        N, P = shapes[name]
        print(f"## kernel {name} {dtn} C={C} P={P} N={N} ({path}): device "
              f"{r['ms']:.4f} ms (per call {r['call_ms']:.4f} ms), plain "
              f"device {r['plain_ms']:.4f} ms (per call "
              f"{r['plain_call_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max|err| {r['err']:.3e}")
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
            lambda: kernels.interp_bary(vert, met, vids, pts),
            lambda: kernels.interp_bary_plain(vert, met, vids, pts),
            err, *bound("interp_bary", 1, D * P, D * Q, isz, dtn))
        r = results[("interp_bary", dtn, 1)]
        same = bool(torch.equal(b, b0) and torch.equal(mq, mq0))
        print(f"## kernel interp_bary {dtn} C=1 D={D} P={P} Q={Q}: device "
              f"{r['ms']:.4f} ms (per call {r['call_ms']:.4f} ms), plain "
              f"device {r['plain_ms']:.4f} ms (per call "
              f"{r['plain_call_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max|err| {r['err']:.3e}, "
              f"bit for bit: {same}, {clamped} of {D * Q} rows clamped")
    return results


def _history(info):
    keys = ("nsplit", "ncollapse", "nswap", "nmoved", "ne", "np")
    return [tuple(r[k] for k in keys) + (tuple(r.get("shard_ne", ())),)
            for r in info["history"]]


def small_f64_runs() -> None:
    """Phase 4: unit cube n=4 at f64 on the card and on the CPU, through
    `adapt()` and through `adapt_distributed()` on 2 shards with
    -nobalance: the per-sweep histories must be equal."""
    import torch

    from parmmg_tpu_torch.models.adapt import AdaptOptions, adapt
    from parmmg_tpu_torch.models.distributed import (
        DistOptions, adapt_distributed, merge_adapted)
    from parmmg_tpu_torch.utils import conformity, gen

    runs = {
        "centralized": lambda m, d: adapt(m, AdaptOptions(
            hsiz=0.18, niter=1, max_sweeps=6, hgrad=None), device=d),
        "distributed": lambda m, d: adapt_distributed(m, DistOptions(
            hsiz=0.18, niter=2, max_sweeps=6, hgrad=None, nparts=2,
            nobalancing=True, min_shard_elts=16), device=d),
    }
    threads = torch.get_num_threads()
    for label, run in runs.items():
        hist = {}
        for d in ("cuda", "cpu"):
            # one host thread: at these sizes more only add synchronisation
            torch.set_num_threads(1 if d == "cpu" else threads)
            out = run(gen.unit_cube_mesh(4, dtype=torch.float64, device=d),
                      d)
            mm = out[0] if len(out) == 2 else merge_adapted(out[0], out[1])
            require(conformity.check_mesh(mm).ok,
                    f"f64 {label} run on {d} not conforming")
            hist[d] = _history(out[-1])
            print(f"## f64 n=4 {label} on {d}: ne {int(mm.ntet)} status "
                  f"{int(out[-1]['status'])} history {hist[d]}")
        first = next((i for i, (a, b) in enumerate(zip(hist["cuda"],
                                                       hist["cpu"]))
                      if a != b), None)
        require(hist["cuda"] == hist["cpu"],
                f"f64 {label} run: the card's per-sweep history differs "
                f"from the CPU's (first at sweep record {first})")
    torch.set_num_threads(threads)


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
    profile_main_path(CUBE_N, HSIZ, m)
    print(f"## phase 2 done at {time.perf_counter() - t0:.1f} s", flush=True)
    m_d, launches_d, shapes_d = distributed_path(CUBE_N, DIST_NE_RANGE)
    print(f"## phase 2c done at {time.perf_counter() - t0:.1f} s", flush=True)
    results = check_kernels(m, shapes, HSIZ, "centralized")
    # the same kernels at the per-shard shapes of the distributed path
    n_d, p_d = shapes_d["quality_vol"]
    require(all(shapes_d[k][1] == p_d for k in CENTRAL),
            f"the distributed path's kernels saw unequal tables {shapes_d}")
    src = shard_source(m_d, NPARTS, p_d)
    check_kernels(src, shapes_d, median_size(src), "distributed")
    results.update(check_interp(m_d, shapes_d))
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
