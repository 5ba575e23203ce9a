"""Single-shard adaptation driver: the batched analog of the Mmg kernel.

Counterpart of `parmmg_tpu/models/adapt.py` on the full-table sweep path
(`AdaptOptions(frontier=False)`). The host runs Jacobi *sweeps* of the
batched operators — split long edges, collapse short ones, 3-2/2-3 swaps,
smoothing — until the mesh is a unit mesh for the metric, growing
capacities between sweeps. Every sweep is the JAX package's per-op
(`fused=False`) sweep: each operator is a plain function on tensors, and
the phase skip and capacity decisions are host branches on synced
scalars.

Not ported in this slice, refused with `NotImplementedError` naming the
ROADMAP item that brings them: active-set (frontier) sweeps, solution
fields/level-set/displacement post-passes, checkpointing, fault
injection, the run governor and kernel-mode switching.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import adjacency, metric as metric_mod, tags
from ..core.mesh import Mesh, compact, tet_volumes
from ..ops import analysis, collapse, quality, smooth, split, swap
from ..ops.common import scatter, take


class MemoryBudgetError(RuntimeError):
    """The configured device-memory budget blocks a needed growth."""


class NumericalError(RuntimeError):
    """Phase-boundary validation failed (non-finite coordinates or
    metric, non-positive tets, out-of-range connectivity)."""


@dataclasses.dataclass
class AdaptOptions:
    """Adaptation controls (the JAX package's `AdaptOptions` surface)."""

    niter: int = 3              # outer iterations
    max_sweeps: int = 12        # operator sweeps per iteration
    hsiz: Optional[float] = None    # constant target size (-hsiz)
    hmin: Optional[float] = None
    hmax: Optional[float] = None
    hgrad: Optional[float] = 1.3    # size gradation (-hgrad), None = off
    # Hausdorff bound for boundary modification; None = 0.01 x bbox diag
    hausd: Optional[float] = None
    # feature-detection dihedral angle in degrees (-ar); None = -nr
    angle: Optional[float] = 45.0
    optim: bool = False         # keep implied sizes (-optim)
    optim_les: bool = False     # -optimLES (iso only)
    aniso: bool = False         # -A: anisotropy without a metric file
    nofem: bool = False         # -nofem: accepted for call parity
    hgradreq: Optional[float] = None  # gradation from required entities
    local_params: tuple = ()    # parsop per-reference overrides
    noinsert: bool = False
    nosurf: bool = False
    noswap: bool = False
    nomove: bool = False
    opnbdy: bool = False        # preserve open internal boundaries
    # convergence: stop sweeping when ops this sweep <= frac * ntet
    converge_frac: float = 0.005
    # post-convergence quality-only sweeps, each kept only if it improves
    polish_sweeps: int = 2
    grow_trigger: float = 0.85
    grow_factor: float = 1.6
    # device-memory budget in MB for the mesh arrays; None = 90% of the
    # device's memory (the host's, on the CPU)
    mem_budget_mb: Optional[float] = None
    # active-set sweeps are the next slice (ROADMAP queue 1, item 10);
    # True is refused until then
    frontier: bool = False
    # phase-boundary validation after every iteration: "off" | "basic"
    # (finite coordinates and metric, positive live tets, connectivity
    # in range)
    validate: str = "basic"
    # refused (ROADMAP queue 1, item 15 — host-side layers)
    checkpoint_dir: Optional[str] = None
    checkpoint_store: Optional[object] = None
    faults: Optional[object] = None
    govern: Optional[bool] = None
    # refused: the port has no kernel-mode switch
    kernels: Optional[str] = None
    verbose: int = 0


def check_supported(opts: AdaptOptions) -> None:
    """Raise `NotImplementedError` for every option this slice of the
    port does not carry."""
    if opts.frontier:
        raise NotImplementedError(
            "frontier (active-set) sweeps are not ported yet: ROADMAP "
            "queue 1, item 10 brings them; pass frontier=False (CLI "
            "-nofrontier is the default here)"
        )
    for name in ("checkpoint_dir", "checkpoint_store", "faults", "govern"):
        if getattr(opts, name) not in (None, False):
            raise NotImplementedError(
                f"AdaptOptions.{name} is not ported yet: ROADMAP queue 1, "
                "item 15 (failsafe/checkpoint, fault plan, governor) "
                "brings it"
            )
    if opts.kernels is not None:
        raise NotImplementedError(
            "AdaptOptions.kernels: the port has no kernel-mode switch — "
            "CUDA tensors always run the CUDA kernels (ROADMAP queue 2)"
        )
    if opts.validate == "full":
        raise NotImplementedError(
            "validate='full' (host conformity + communicator checks) is "
            "not ported yet: ROADMAP queue 1, item 15 (failsafe) brings it")
    if opts.validate not in ("off", "basic"):
        raise ValueError(f"unknown validate level {opts.validate!r}")


class SweepStats(NamedTuple):
    nsplit: torch.Tensor
    ncollapse: torch.Tensor
    nswap: torch.Tensor
    nmoved: torch.Tensor
    n_unique: torch.Tensor
    split_capped: torch.Tensor
    n_active: torch.Tensor
    n_len_unit: torch.Tensor
    n_len_edges: torch.Tensor


def _len_band_counts(mesh: Mesh, edges, emask):
    """(edges of the sweep's exit tables with metric length in [LSHRT,
    LLONG], edges measured)."""
    a, b = edges[:, 0], edges[:, 1]
    l = metric_mod.edge_length(take(mesh.vert, a), take(mesh.vert, b),
                               take(mesh.met, a), take(mesh.met, b))
    band = emask & (l >= metric_mod.LSHRT) & (l <= metric_mod.LLONG)
    return band.to(torch.int32).sum(), emask.to(torch.int32).sum()


def _sweep_body(mesh: Mesh, ecap: int, noinsert: bool = False,
                noswap: bool = False, nomove: bool = False,
                nosurf: bool = False, hausd=0.01, phase_skip: bool = True):
    """One full-table sweep: split → (collapse → swaps → smooth unless
    the sweep is split-dominant). Compaction runs before every operator
    that allocates, so live entities form array prefixes. Returns (mesh,
    SweepStats)."""
    zero = torch.zeros((), dtype=torch.int32, device=mesh.device)
    mesh = compact(mesh)
    edges, emask, t2e, n_unique = adjacency.unique_edges(mesh, ecap)
    n_active = n_unique
    growth = False
    if not noinsert:
        mesh, s_split = split.split_long_edges(mesh, edges, emask, t2e,
                                               nosurf=nosurf)
        mesh = compact(mesh)
        edges, emask, t2e, nu = adjacency.unique_edges(mesh, ecap)
        n_unique = torch.maximum(n_unique, nu)
        nsplit, capped = s_split.nsplit, s_split.capped
        if phase_skip:
            # split-dominant sweeps skip the quality tail (host branch)
            growth = bool(
                (nsplit > torch.clamp(mesh.ntet // 10, min=64)) & ~capped
            )
    else:
        nsplit = zero
        capped = torch.zeros((), dtype=torch.bool, device=mesh.device)

    ncollapse = nswap = nmoved = zero
    if not growth:
        mesh, s_col = collapse.collapse_short_edges(
            mesh, edges, emask, t2e, hausd=hausd, nosurf=nosurf)
        ncollapse = s_col.ncollapse
        mesh = compact(mesh)
        edges, emask, t2e, nu = adjacency.unique_edges(mesh, ecap)
        n_unique = torch.maximum(n_unique, nu)
        if not noswap:
            mesh, s_32 = swap.swap_32(mesh, edges, emask, t2e)
            # swaps delete no vertex: the post-collapse edge list stays
            # valid for swap_23's new-edge check and for smoothing
            mesh = adjacency.build_adjacency(compact(mesh))
            mesh, s_23 = swap.swap_23(mesh, edges, emask)
            mesh = compact(mesh)
            nswap = s_32.nswap32 + s_23.nswap23
        if not nomove:
            mesh, s_sm = smooth.smooth_vertices(mesh, edges, emask,
                                                nosurf=nosurf)
            nmoved = s_sm.nmoved

    n_len_unit, n_len_edges = _len_band_counts(mesh, edges, emask)
    return mesh, SweepStats(
        nsplit=nsplit, ncollapse=ncollapse, nswap=nswap, nmoved=nmoved,
        n_unique=n_unique, split_capped=capped, n_active=n_active,
        n_len_unit=n_len_unit, n_len_edges=n_len_edges,
    )


# history columns: one row of host ints per executed sweep
HIST_COLS = (
    "nsplit", "ncollapse", "nswap", "nmoved", "ne", "np", "n_unique",
    "capped", "n_active", "n_len_unit", "n_len_edges",
)


def _hist_row(stats: SweepStats, mesh: Mesh) -> dict:
    """One history record in HIST_COLS order (one host sync)."""
    vals = torch.stack([
        stats.nsplit, stats.ncollapse, stats.nswap, stats.nmoved,
        mesh.ntet, mesh.npoin, stats.n_unique, stats.split_capped,
        stats.n_active, stats.n_len_unit, stats.n_len_edges,
    ]).to(torch.int64).tolist()
    rec = dict(zip(HIST_COLS, (int(v) for v in vals)))
    rec["capped"] = bool(rec["capped"])
    return rec


def resolve_hausd(mesh: Mesh, opts: AdaptOptions) -> float:
    """-hausd value, defaulting to 0.01 x bounding-box diagonal."""
    if opts.hausd is not None:
        return float(opts.hausd)
    live = mesh.vmask[:, None]
    lo = torch.where(live, mesh.vert, torch.inf).min(dim=0).values
    hi = torch.where(live, mesh.vert, -torch.inf).max(dim=0).values
    diag = float(torch.linalg.norm(hi - lo))
    return 0.01 * (diag if diag > 0 else 1.0)


def prepare_metric(mesh: Mesh, opts: AdaptOptions, ecap: int) -> Mesh:
    """Metric setup: constant size / implied size / bounds / gradation."""
    if opts.optim_les and (opts.aniso or mesh.met.shape[1] == 6):
        raise ValueError("-optimLES is incompatible with an aniso metric "
                         "(reference parsar discipline)")
    met = mesh.met
    is_iso = met.shape[1] == 1
    if opts.hsiz is not None:
        met = metric_mod.constant_iso_metric(mesh.pcap, opts.hsiz,
                                             mesh.dtype, mesh.device)
    elif is_iso and opts.aniso and not mesh.met_set:
        met = metric_mod.implied_aniso_metric(
            mesh.vert, mesh.tet, mesh.tmask, mesh.pcap).to(mesh.dtype)
        is_iso = False
    elif is_iso and (opts.optim or opts.optim_les or not mesh.met_set):
        met = metric_mod.implied_iso_metric(
            mesh.vert, mesh.tet, mesh.tmask, mesh.pcap).to(mesh.dtype)
    if opts.aniso and met.shape[1] == 1:
        met = metric_mod.iso_to_sym6(met)
    met = metric_mod.apply_hbounds(met, opts.hmin, opts.hmax)
    met = _apply_local_hbounds(mesh, met, opts.local_params)
    mesh = mesh.replace(met=met, met_set=True)
    if opts.hgrad is not None or opts.hgradreq is not None:
        # honor unique_edges' overflow contract: retry with a larger cap
        while True:
            edges, emask, _, nu = adjacency.unique_edges(mesh, ecap)
            if int(nu) <= ecap:
                break
            ecap = int(int(nu) * 1.1) + 64
        gradate = (metric_mod.gradate_iso if met.shape[1] == 1
                   else metric_mod.gradate_aniso)
        met = mesh.met
        req = (((mesh.vtag & tags.REQUIRED) != 0) & mesh.vmask
               if opts.hgradreq is not None else None)
        if opts.hgrad is not None:
            met = gradate(mesh.vert, met, edges, emask, hgrad=opts.hgrad,
                          fixed=req)
        if opts.hgradreq is not None:
            met = metric_mod.gradate_from_required(
                mesh.vert, met, edges, emask, req, hgrad=opts.hgradreq)
        mesh = mesh.replace(met=met)
    return mesh


def _apply_local_hbounds(mesh: Mesh, met, local_params):
    """Per-reference hmin/hmax clamps from parsop local parameters."""
    for lp in local_params:
        if lp.elt == "vertex":
            sel = (mesh.vref == lp.ref) & mesh.vmask
        else:
            conn, refs, emask2 = (
                (mesh.tria, mesh.trref, mesh.trmask)
                if lp.elt == "triangle"
                else (mesh.tet, mesh.tref, mesh.tmask)
            )
            hit = (refs == lp.ref) & emask2
            sel = torch.zeros(mesh.pcap, dtype=torch.bool,
                              device=mesh.device)
            sel = scatter(sel, torch.where(hit[:, None], conn,
                                           mesh.pcap).reshape(-1), True)
        clamped = metric_mod.apply_hbounds(met, lp.hmin, lp.hmax)
        met = torch.where(sel[:, None], clamped, met)
    return met


def local_hausd_table(mesh: Mesh, opts: AdaptOptions, hausd: float):
    """Per-tria-reference hausd lookup table, or the scalar unchanged
    when no local triangle hausd is set."""
    trs = [lp for lp in opts.local_params
           if lp.elt == "triangle" and lp.hausd > 0]
    if not trs:
        return hausd
    rmax = max(int(torch.where(mesh.trmask, mesh.trref, 0).max()),
               max(lp.ref for lp in trs))
    table = np.full(rmax + 1, hausd, np.float64)
    for lp in trs:
        table[lp.ref] = lp.hausd
    return torch.as_tensor(table, dtype=mesh.dtype, device=mesh.device)


def estimate_target_ntet(mesh: Mesh) -> int:
    """Predicted element count of the unit mesh for the current metric:
    12 * sum_t vol(t) * mean sqrt(det M) over its corners."""
    vol = torch.where(mesh.tmask, tet_volumes(mesh), 0.0)
    dens = metric_mod.metric_det(mesh.met)
    dens_t = torch.sqrt(torch.clamp(take(dens, mesh.tet), min=0.0)) \
        .mean(dim=1)
    est = 12.0 * torch.sum(vol * dens_t)
    return int(est) + 1


def _counts(mesh: Mesh):
    vals = torch.stack([mesh.npoin, mesh.ntet, mesh.ntria,
                        mesh.nedge]).tolist()
    return tuple(int(v) for v in vals)


def estimate_mesh_bytes(mesh: Mesh, pc: int, tc: int, fc: int,
                        ec: int) -> int:
    """Device bytes the mesh tensors would occupy at these capacities."""
    fs = torch.finfo(mesh.dtype).bits // 8
    per_v = 3 * fs + 4 * 3 + 1 + (
        mesh.met.shape[-1] + mesh.ls.shape[-1] + mesh.disp.shape[-1]
        + mesh.fields.shape[-1]
    ) * fs + 4
    per_t = 4 * 4 + 4 + 1 + 4 * 4
    per_f = 3 * 4 + 4 + 4 + 1
    per_e = 2 * 4 + 4 + 4 + 1
    return pc * per_v + tc * per_t + fc * per_f + ec * per_e


def default_mem_budget_mb(device) -> Optional[float]:
    """Budget when `AdaptOptions.mem_budget_mb` is unset: 90% of the
    GPU's total memory (`torch.cuda.mem_get_info`), or 90% of the host's
    MemAvailable for a CPU run; None when neither is readable."""
    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return 0.9 * float(total) / 1e6
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return 0.9 * float(line.split()[1]) / 1e3
    except (OSError, ValueError, IndexError):
        pass
    return None


def _check_budget(mesh: Mesh, opts: AdaptOptions, pc, tc, fc, ec):
    if opts.mem_budget_mb is None:
        return
    need = estimate_mesh_bytes(mesh, pc, tc, fc, ec)
    if need > opts.mem_budget_mb * 1e6:
        raise MemoryBudgetError(
            f"mesh memory budget exceeded: growth to caps "
            f"(p={pc}, t={tc}, f={fc}, e={ec}) needs "
            f"{need / 1e6:.1f} MB > budget {opts.mem_budget_mb} MB"
        )


def ensure_capacity(mesh: Mesh, opts: AdaptOptions) -> Mesh:
    """Grow capacities (geometrically) when utilization crosses the
    trigger; a configured memory budget caps growth."""
    npo, nte, ntr, ned = _counts(mesh)
    g = opts.grow_factor

    def target(n, cap):
        if n > opts.grow_trigger * cap:
            return max(int(n * g) + 8, int(cap * g))
        return cap

    pc = target(npo, mesh.pcap)
    tc = target(nte, mesh.tcap)
    fc = target(ntr, mesh.fcap)
    ec = target(ned, mesh.ecap)
    if (pc, tc, fc, ec) != (mesh.pcap, mesh.tcap, mesh.fcap, mesh.ecap):
        _check_budget(mesh, opts, pc, tc, fc, ec)
        mesh = mesh.with_capacity(pc, tc, fc, ec)
    return mesh


def _rec_in_band(rec: dict) -> dict:
    """Attach the unit-band edge fraction `in_band` to a history
    record."""
    if "in_band" not in rec and "n_len_unit" in rec:
        rec["in_band"] = round(
            rec["n_len_unit"] / max(rec.get("n_len_edges", 0), 1), 6
        )
    return rec


def run_sweep_loop(state, opts: AdaptOptions, emult: List[float],
                   history: List[dict], it: int, ensure_fn, tcap_fn,
                   sweep_fn):
    """Sweep-to-convergence engine shared by the single-shard and the
    stacked drivers: capacity growth between sweeps, unique-edge cap
    overflow handling (with a bounded budget extension) and the
    `converge_frac` stopping rule.

    `ensure_fn(state) -> state` grows capacities; `tcap_fn(state)` is the
    tet capacity the unique-edge cap follows; `sweep_fn(state, ecap) ->
    (state, rec)` runs one sweep and returns its host record (nsplit,
    ncollapse, nswap, nmoved, ne, np summed over shards, n_unique the
    largest, capped any)."""
    sweep = 0
    budget = opts.max_sweeps
    while sweep < budget:
        state = ensure_fn(state)
        ecap = int(tcap_fn(state) * emult[0]) + 64
        state, rec = sweep_fn(state, ecap)
        _rec_in_band(rec)
        overflow = rec["n_unique"] > ecap
        if overflow:
            # unique_edges dropped edges this sweep: grow the cap and
            # give the lost coverage a sweep back
            emult[0] = max(emult[0] * 1.5,
                           1.1 * rec["n_unique"] / max(tcap_fn(state), 1))
            if budget < opts.max_sweeps + 4:
                budget += 1
        rec.update(iter=it, sweep=sweep)
        history.append(rec)
        if opts.verbose >= 2:
            print(
                f"  it {it} sweep {sweep}: +{rec['nsplit']} split "
                f"-{rec['ncollapse']} collapse {rec['nswap']} swap "
                f"{rec['nmoved']} moved -> ne={rec['ne']}",
                flush=True,
            )
        nops = rec["nsplit"] + rec["ncollapse"] + rec["nswap"]
        if (not rec["capped"] and not overflow
                and nops <= opts.converge_frac * max(rec["ne"], 1)):
            break
        sweep += 1
    return state


def run_batched_sweep_loop(mesh: Mesh, opts: AdaptOptions,
                           emult: List[float], history: List[dict],
                           it: int, hausd) -> Mesh:
    """The single-shard sweep loop: `run_sweep_loop` over `_sweep_body`."""
    def sweep_fn(m, ecap):
        m, stats = _sweep_body(
            m, ecap, noinsert=opts.noinsert, noswap=opts.noswap,
            nomove=opts.nomove, nosurf=opts.nosurf, hausd=hausd,
        )
        return m, _hist_row(stats, m)

    return run_sweep_loop(mesh, opts, emult, history, it,
                          ensure_fn=lambda m: ensure_capacity(m, opts),
                          tcap_fn=lambda m: m.tcap, sweep_fn=sweep_fn)


def _hist_key(h):
    """Lexicographic goodness of a quality histogram: floor first, then
    a thin worst bin, then the average."""
    return (float(h.qmin), -int(h.counts[0]), float(h.qavg))


def _polish(mesh: Mesh, opts: AdaptOptions, emult, hausd) -> Mesh:
    """Up to `polish_sweeps` insertion-free sweeps, each kept only if
    the quality histogram improves."""
    if opts.polish_sweeps <= 0 or (opts.noswap and opts.nomove):
        return mesh
    best_h = quality.quality_histogram(mesh)
    best = mesh.clone()
    cur = mesh
    ecap = int(mesh.tcap * emult[0]) + 64
    for _ in range(opts.polish_sweeps):
        cur, st = _sweep_body(
            cur, ecap, noinsert=True, noswap=opts.noswap,
            nomove=opts.nomove, nosurf=opts.nosurf, hausd=hausd,
            phase_skip=False,
        )
        h = quality.quality_histogram(cur)
        nops = int(st.ncollapse + st.nswap + st.nmoved)
        if _hist_key(h) > _hist_key(best_h):
            best, best_h = cur.clone(), h
        if nops == 0:
            break
    return best


def sanity_counts(mesh: Mesh) -> torch.Tensor:
    """[4] int: (non-finite vertices, non-finite metric rows,
    non-positive tets, tets with out-of-range or dead connectivity) over
    the live entities."""
    bad_v = (mesh.vmask & ~torch.isfinite(mesh.vert).all(dim=-1)).sum()
    bad_m = (mesh.vmask & ~torch.isfinite(mesh.met).all(dim=-1)).sum()
    vol = tet_volumes(mesh)
    n_inv = (mesh.tmask & ~(vol > 0)).sum()
    pcap = mesh.pcap
    in_rng = (mesh.tet >= 0) & (mesh.tet < pcap)
    live = take(mesh.vmask, torch.clamp(mesh.tet, 0, pcap - 1))
    n_oob = (mesh.tmask & ~(in_rng & live).all(dim=1)).sum()
    return torch.stack([bad_v, bad_m, n_inv, n_oob])


def validate(mesh, opts: AdaptOptions, it: int) -> None:
    """Phase-boundary validation at `opts.validate` level of a mesh or a
    list of shards (counts summed over the shards); raises
    `NumericalError`."""
    if opts.validate == "off":
        return
    shards = mesh if isinstance(mesh, list) else [mesh]
    rep = [int(v) for v in
           torch.stack([sanity_counts(m) for m in shards]).sum(0).tolist()]
    if any(rep):
        raise NumericalError(
            f"phase-boundary validation failed after remesh (it {it}): "
            f"{rep[0]} non-finite vertices, {rep[1]} non-finite metric "
            f"rows, {rep[2]} non-positive tets, {rep[3]} tets with "
            "out-of-range connectivity"
        )


def adapt(mesh: Mesh, opts: AdaptOptions | None = None, device=None,
          phase_hook=None):
    """Adapt `mesh` to its metric on `device` (default: the GPU — raises
    when there is none). Returns (mesh, info) with info keys `history`,
    `qual_in`, `qual_out`, `len_out` and `status`.

    `opts.niter` outer iterations of up to `opts.max_sweeps` sweeps each;
    every iteration is validated at its boundary (`opts.validate`) and
    rolled back to its start on failure, which ends the run with
    LOWFAILURE. `phase_hook(name)` is called at each phase boundary."""
    device = resolve_device(device)
    opts = opts or AdaptOptions()
    check_supported(opts)
    if mesh.fields.shape[1] + mesh.ls.shape[1] + mesh.disp.shape[1]:
        raise NotImplementedError(
            "meshes carrying solution fields, a level-set or a "
            "displacement need the fields post-pass (interp_fields_only), "
            "which ROADMAP queue 1, item 11 brings"
        )
    mesh = mesh.to(device)
    if opts.mem_budget_mb is None:
        derived = default_mem_budget_mb(device)
        if derived is not None:
            opts = dataclasses.replace(opts, mem_budget_mb=derived)
    emult = [1.6]

    def _phase(name):
        if phase_hook is not None:
            phase_hook(name)
        if opts.verbose >= 2:
            print(f"  ## phase: {name}", flush=True)

    mesh = ensure_capacity(mesh, opts)
    _phase("analysis")
    mesh = analysis.analyze(mesh, ang=opts.angle, opnbdy=opts.opnbdy)
    _phase("metric")
    mesh = prepare_metric(mesh, opts, int(mesh.tcap * emult[0]) + 64)
    hausd = local_hausd_table(mesh, opts, resolve_hausd(mesh, opts))
    _phase("input histogram")
    h0 = quality.quality_histogram(mesh)
    _phase("sweeps")

    # pre-size capacities for the predicted unit mesh; skipped (with a
    # warning) when it would exceed the memory budget
    est_ne = int(estimate_target_ntet(mesh) * 1.35) + 64
    if est_ne > mesh.tcap:
        want = (
            max(mesh.pcap, est_ne // 5 + 64),
            est_ne,
            max(mesh.fcap, est_ne // 4 + 64),
            max(mesh.ecap, est_ne // 16 + 64),
        )
        try:
            _check_budget(mesh, opts, *want)
        except MemoryBudgetError as exc:
            if opts.verbose >= 1:
                print(f"  ## Warning: presizing skipped ({exc}); "
                      "growing incrementally under the memory budget")
        else:
            mesh = mesh.with_capacity(*want)

    history: List[dict] = []
    status = tags.ReturnStatus.SUCCESS
    last_good = mesh.clone()
    for it in range(opts.niter):
        try:
            mesh = run_batched_sweep_loop(mesh, opts, emult, history, it,
                                          hausd)
            validate(mesh, opts, it)
        except NumericalError as e:
            history.append(dict(iter=it, phase="remesh", failure=str(e),
                                error=type(e).__name__))
            mesh = last_good
            status = tags.ReturnStatus.LOWFAILURE
            break
        last_good = mesh.clone()

    _phase("finalize")
    mesh = _polish(mesh, opts, emult, hausd)
    mesh = compact(mesh)
    h1 = quality.quality_histogram(mesh)
    len_out = quality.mesh_length_stats(mesh)
    info = dict(history=history, qual_in=h0, qual_out=h1, len_out=len_out,
                status=status)
    return mesh, info
