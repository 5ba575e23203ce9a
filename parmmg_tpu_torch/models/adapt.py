"""Single-shard adaptation driver: the batched analog of the Mmg kernel.

Counterpart of `parmmg_tpu/models/adapt.py`. The host runs Jacobi
*sweeps* of the batched operators — split long edges, collapse short
ones, 3-2/2-3 swaps, smoothing — until the mesh is a unit mesh for the
metric, growing capacities between sweeps. Every sweep is the JAX
package's per-op (`fused=False`) sweep: each operator is a plain
function on tensors, and the phase skip, capacity and frontier
decisions are host branches on synced scalars.

Sweeps are active-set (frontier) sweeps by default, as in the JAX
package: each sweep records the vertices it changed, the next one gates
its candidates on their one-ring closure and reuses or merges the edge
and face tables instead of rebuilding them. `frontier=False` gives the
full-table sweeps.

A mesh that carries solution fields, a level set or a displacement
has them re-interpolated once from the input (`interp_fields_only`)
after the final polish and compaction.

Not ported, refused with `NotImplementedError` naming the ROADMAP item
that brings them: checkpointing and the failsafe layer's other options
(validation cadence, recovery attempts, watchdog), fault injection, the
run governor and kernel-mode switching.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import adjacency, metric as metric_mod, tags
from ..core.mesh import Mesh, compact, compact_aux, tet_volumes
from ..ops import (analysis, collapse, common, interp, quality, smooth,
                   split, swap)
from ..ops.common import scatter, take


class AdaptError(RuntimeError):
    """Base of the typed failures (always also a RuntimeError, so the
    drivers' rollback absorbs them)."""


class CapacityError(AdaptError):
    """A static capacity (shard slots, entity tables) was undershot.

    Recoverable: the caller can grow the capacities and retry. Carries
    the overflow the raising site computed:

    - ``overflow``: ``[D, 4]`` int array of per-shard excess ``[verts,
      tets, trias, edges]`` (integrate-side overflow), or None;
    - ``counts`` / ``caps``: pack-side per-destination counts vs the
      static slot caps ``[tets, trias, edges]``, or None.
    """

    def __init__(self, message: str, *, overflow=None, counts=None,
                 caps=None):
        super().__init__(message)
        self.overflow = None if overflow is None else np.asarray(overflow)
        self.counts = None if counts is None else np.asarray(counts)
        self.caps = None if caps is None else np.asarray(caps)


class MemoryBudgetError(AdaptError):
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
    # active-set (frontier) sweeps: each sweep records the vertices it
    # changed and the next one addresses only entities near them (CLI
    # -nofrontier / False = full-table sweeps)
    frontier: bool = True
    # phase-boundary validation after every iteration: "off" | "basic"
    # (finite coordinates and metric, positive live tets, connectivity
    # in range)
    validate: str = "basic"
    # closed-loop balance band of the distributed driver: measured work
    # imbalance (max/mean) above it forces a full re-cut, with hysteresis
    # (CLI -balance); None = PMMGTPU_BALANCE_BAND, else 1.5; <= 0 turns
    # the policy off (-nobalance turns off all resharding)
    balance_band: Optional[float] = None
    # refused (ROADMAP queue 1, item 15 — host-side layers): the first
    # four when set, the others when set away from their defaults
    checkpoint_dir: Optional[str] = None
    checkpoint_store: Optional[object] = None
    faults: Optional[object] = None
    govern: Optional[bool] = None
    validate_every: int = 1
    recovery_attempts: int = 2
    checkpoint_every: int = 1
    checkpoint_async: bool = False
    checkpoint_keep: int = 2
    watchdog_timeout: Optional[float] = None
    # refused: the port has no kernel-mode switch
    kernels: Optional[str] = None
    verbose: int = 0


# the options of ROADMAP item 15: refused when set, or when set away from
# their defaults
_ITEM15_SET = ("checkpoint_dir", "checkpoint_store", "faults", "govern")
_ITEM15_DEFAULTED = ("validate_every", "recovery_attempts",
                     "checkpoint_every", "checkpoint_async",
                     "checkpoint_keep", "watchdog_timeout")


def check_supported(opts: AdaptOptions) -> None:
    """Raise `NotImplementedError` for every option this slice of the
    port does not carry."""
    default = {f.name: f.default for f in dataclasses.fields(AdaptOptions)}
    for name in _ITEM15_SET + _ITEM15_DEFAULTED:
        value = getattr(opts, name)
        if (value not in (None, False) if name in _ITEM15_SET
                else value != default[name]):
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


class Frontier(NamedTuple):
    """Active-set state carried from one sweep to the next.

    `changed` is the raw [PC] bool set of vertices the previous sweep
    changed (geometry beyond smooth.MOVE_TOL, or 1-ring topology); each
    operator gates on its one-ring closure. `dirty` (host int) is the
    staleness level of `tables` = (edges, emask, t2e, n_unique), the
    edge tables of the last rebuild: 0 = current (reuse them), 1 =
    topology deltas with stable numbering since (merge them with
    `adjacency.merge_unique_edges`), 2 = a compaction with holes
    renumbered the tets since (compact and rebuild). `adja_ok` (host
    bool) marks `mesh.adja` valid for the current numbering."""

    changed: torch.Tensor
    dirty: int
    tables: tuple
    adja_ok: bool

    @staticmethod
    def from_jax_state(arrays: dict, device=None) -> "Frontier":
        """The port's Frontier from a JAX package's `Frontier` as numpy
        arrays (keys `changed`, `dirty`, `edges`, `emask`, `t2e`,
        `n_unique`, `adja_ok`), as `Mesh.from_jax_state` does for a
        mesh."""
        from .. import resolve_device

        dev = resolve_device(device)

        def t(k, dtype):
            return torch.as_tensor(np.asarray(arrays[k]), dtype=dtype,
                                   device=dev)

        return Frontier(
            changed=t("changed", torch.bool),
            dirty=int(np.asarray(arrays["dirty"])),
            tables=(t("edges", torch.int32), t("emask", torch.bool),
                    t("t2e", torch.int32), t("n_unique", torch.int32)),
            adja_ok=bool(np.asarray(arrays["adja_ok"])),
        )


def empty_frontier(mesh: Mesh, ecap: int) -> Frontier:
    """Initial frontier: every vertex active (which reproduces the
    full-table sweep) over stale tables."""
    dev = mesh.device
    tables = (
        torch.zeros((ecap, 2), dtype=torch.int32, device=dev),
        torch.zeros(ecap, dtype=torch.bool, device=dev),
        torch.full((mesh.tcap, 6), -1, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
    )
    return Frontier(torch.ones(mesh.pcap, dtype=torch.bool, device=dev),
                    2, tables, False)


def pad_changed(changed, pcap: int):
    """Changed masks (one per shard) padded to a grown vertex capacity:
    growth appends slots, so ids are stable and the new tail is
    inactive. Capacities never shrink."""
    return [torch.cat([c, c.new_zeros(pcap - c.shape[0])])
            if c.shape[0] < pcap else c for c in changed]


def _sweep_body(mesh: Mesh, ecap: int, noinsert: bool = False,
                noswap: bool = False, nomove: bool = False,
                nosurf: bool = False, hausd=0.01, phase_skip: bool = True,
                frontier: Optional[Frontier] = None):
    """One sweep: split → (collapse → swaps → smooth unless the sweep is
    split-dominant). Compaction runs before every operator that
    allocates, so live entities form array prefixes. Returns (mesh,
    SweepStats), and the successor Frontier as a third element when
    `frontier` is given.

    Full-table sweep (`frontier=None`): the tables are rebuilt after
    every topological operator. Frontier sweep: candidates are gated on
    the one-ring closure of what changed, the entry tables are reused,
    merged or rebuilt by `frontier.dirty`, a table is rebuilt after an
    operator only when it acted, `build_adjacency` before the 2-3 swap is
    skipped while the adjacency is valid and the swapped faces are
    re-matched in place after it. Every such decision is a host read."""
    fr = frontier is not None
    dev = mesh.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def _closure(m, base):
        return common.one_ring_closure(m.tet, m.tmask, base)

    if not fr:
        mesh = compact(mesh)
        edges, emask, t2e, n_unique = adjacency.unique_edges(mesh, ecap)
        n_active = n_unique
        act = chg = adja_ok = None
    else:
        act, dirty, tables_in, adja_ok = frontier
        if dirty >= 2:
            # a renumbering compaction ran: compact and re-sort
            mesh, act = compact_aux(mesh, act)
            edges, emask, t2e, n_unique = adjacency.unique_edges(mesh, ecap)
            adja_ok = False
        elif dirty >= 1:
            # stable-numbering deltas: fold them into the tables
            edges, emask, t2e, n_unique = adjacency.merge_unique_edges(
                mesh, act, *tables_in, K=max(64, mesh.tcap // 4))
        else:
            edges, emask, t2e, n_unique = tables_in
        chg = torch.zeros(mesh.pcap, dtype=torch.bool, device=dev)
        g0 = _closure(mesh, act)
        n_active = (emask & (take(g0, edges[:, 0]) | take(g0, edges[:, 1]))
                    ).to(torch.int32).sum()

    def _rebuild(m, aux):
        """compact (+ the frontier masks) and a fresh edge table."""
        if aux is None:
            m = compact(m)
        else:
            m, aux = compact_aux(m, aux)
        e, em, t2, nu = adjacency.unique_edges(m, ecap)
        return m, aux, e, em, t2, torch.maximum(n_unique, nu)

    growth = did_split = False
    if not noinsert:
        mesh, s_split = split.split_long_edges(
            mesh, edges, emask, t2e, nosurf=nosurf,
            active=g0 if fr else None)
        nsplit, capped = s_split.nsplit, s_split.capped
        # split-dominant sweeps skip the quality tail (host branch)
        split_dominant = (nsplit > torch.clamp(mesh.ntet // 10, min=64)) \
            & ~capped
        if not fr:
            mesh, _, edges, emask, t2e, n_unique = _rebuild(mesh, None)
            growth = phase_skip and bool(split_dominant)
        else:
            # one host read for both decisions (compaction keeps ntet)
            did_split, dominant = torch.stack(
                [nsplit > 0, split_dominant]).tolist()
            growth = phase_skip and dominant
            chg = chg | s_split.changed_v
            if did_split:
                mesh, aux, edges, emask, t2e, n_unique = _rebuild(
                    mesh, torch.stack([act, chg], dim=1))
                act, chg = aux[:, 0], aux[:, 1]
    else:
        nsplit = zero
        capped = torch.zeros((), dtype=torch.bool, device=dev)

    ncollapse = nswap = nmoved = zero
    dirty_out = 0
    if growth:
        # the skipped tail leaves the post-split tables, current either
        # way; the adjacency stays valid only if the split did nothing
        if fr:
            adja_ok = adja_ok and not did_split
    else:
        av = act
        mesh, s_col = collapse.collapse_short_edges(
            mesh, edges, emask, t2e, hausd=hausd, nosurf=nosurf,
            active=_closure(mesh, av | chg) if fr else None)
        ncollapse = s_col.ncollapse
        did_collapse = False
        if not fr:
            mesh, _, edges, emask, t2e, n_unique = _rebuild(mesh, None)
        else:
            chg = chg | s_col.changed_v
            did_collapse = bool(ncollapse > 0)
            if did_collapse:
                mesh, aux, edges, emask, t2e, n_unique = _rebuild(
                    mesh, torch.stack([av, chg], dim=1))
                av, chg = aux[:, 0], aux[:, 1]
        if not noswap:
            mesh, s_32 = swap.swap_32(
                mesh, edges, emask, t2e,
                active=_closure(mesh, av | chg) if fr else None)
            # swaps delete no vertex: the post-collapse edge list stays
            # valid for swap_23's new-edge check and for smoothing
            if not fr:
                mesh = adjacency.build_adjacency(compact(mesh))
                mesh, s_23 = swap.swap_23(mesh, edges, emask)
                mesh = compact(mesh)
            else:
                chg = chg | s_32.changed_v
                swapped32 = bool(s_32.nswap32 > 0)
                if not adja_ok or did_split or did_collapse or swapped32:
                    mesh, aux = compact_aux(mesh, torch.stack([av, chg], 1))
                    mesh = adjacency.build_adjacency(mesh)
                    av, chg = aux[:, 0], aux[:, 1]
                mesh, s_23 = swap.swap_23(mesh, edges, emask,
                                          active=_closure(mesh, av | chg))
                chg = chg | s_23.changed_v
                # 2-3 swaps append into the live prefix and delete no
                # vertex: no compaction, the swapped faces are re-matched
                # in place
                swapped23 = bool(s_23.nswap23 > 0)
                if swapped23:
                    mesh = adjacency.update_adjacency(
                        mesh, s_23.changed_v, K=max(64, mesh.tcap // 2))
                adja_ok = True
                # exit tables' staleness: a 3-2 swap left holes, so the
                # compaction above renumbered the tets (2); 2-3 swaps
                # alone are stable-numbering deltas (1)
                dirty_out = 2 if swapped32 else 1 if swapped23 else 0
            nswap = s_32.nswap32 + s_23.nswap23
        elif fr:
            adja_ok = adja_ok and not did_split and not did_collapse
        if not nomove:
            mesh, s_sm = smooth.smooth_vertices(
                mesh, edges, emask, nosurf=nosurf,
                active=_closure(mesh, av | chg) if fr else None)
            nmoved = s_sm.nmoved
            if fr:
                chg = chg | s_sm.changed_v

    n_len_unit, n_len_edges = _len_band_counts(mesh, edges, emask)
    stats = SweepStats(
        nsplit=nsplit, ncollapse=ncollapse, nswap=nswap, nmoved=nmoved,
        n_unique=n_unique, split_capped=capped, n_active=n_active,
        n_len_unit=n_len_unit, n_len_edges=n_len_edges,
    )
    if not fr:
        return mesh, stats
    return mesh, stats, Frontier(changed=chg, dirty=dirty_out,
                                 tables=(edges, emask, t2e, n_unique),
                                 adja_ok=adja_ok)


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
    """The single-shard sweep loop: `run_sweep_loop` over `_sweep_body`.
    With `opts.frontier` the frontier is carried from sweep to sweep; a
    capacity or edge-cap event changes the table shapes and restarts it
    full (the JAX package's unfused loop)."""
    fr_cell: list = [None]

    def sweep_fn(m, ecap):
        kw = dict(noinsert=opts.noinsert, noswap=opts.noswap,
                  nomove=opts.nomove, nosurf=opts.nosurf, hausd=hausd)
        if not opts.frontier:
            m, stats = _sweep_body(m, ecap, **kw)
            return m, _hist_row(stats, m)
        fr = fr_cell[0]
        if (fr is None or fr.changed.shape[0] != m.pcap
                or fr.tables[0].shape[0] != ecap
                or fr.tables[2].shape[0] != m.tcap):
            fr = empty_frontier(m, ecap)
        m, stats, fr_cell[0] = _sweep_body(m, ecap, frontier=fr, **kw)
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

    # snapshot for the solution-field post-pass: the fields are pulled
    # once from the input, so relocation drift cannot accumulate (every
    # operator returns new tensors, so holding the mesh keeps it intact)
    has_sols = (mesh.fields.shape[1] + mesh.ls.shape[1]
                + mesh.disp.shape[1]) > 0
    old_snapshot = mesh if has_sols else None
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
    if old_snapshot is not None:
        mesh = interp.interp_fields_only(mesh, old_snapshot)
    h1 = quality.quality_histogram(mesh)
    len_out = quality.mesh_length_stats(mesh)
    info = dict(history=history, qual_in=h0, qual_out=h1, len_out=len_out,
                status=status)
    return mesh, info
