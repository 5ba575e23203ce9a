"""Distributed remesh driver on one device: shards with frozen
interfaces.

Counterpart of `parmmg_tpu/models/distributed.py` on its single-process
path (`_remesh_phase_local`) with full-table sweeps: the mesh is
partitioned along a Morton curve into `nparts` shards of uniform
capacities, carried as a list of per-shard `Mesh`es; every iteration
remeshes each shard's interior with its PARBDY interfaces frozen, then
re-interpolates the metric from the pre-remesh snapshot; at the end the
shards are stacked once (leading shard axis, as the JAX package's
stacked mesh), the new vertices get global ids and `merge_adapted` joins
the shards into one centralized mesh.

Each sweep runs the single-shard `_sweep_body` once per shard (the JAX
package vmaps it over the shard axis, which gives the same per-shard
results). What the shards share stays shared: the unique-edge cap from
the common tet capacity, growth to the largest shard's need, no
split-dominant phase skip, the convergence rule on the record summed
over shards, and, with frontier sweeps, the tables' staleness level (the
largest over the shards) and adjacency validity (all shards). The
per-shard frontier masks are carried from sweep to sweep and, through
the compaction, from one iteration to the next; a drained carry skips
the iteration's sweeps.

This slice runs with `nobalancing=True` (`-nobalance`): interfaces stay
where the partition put them. Interface displacement and graph balancing
between iterations (`parallel/migrate.py`) are refused with
`NotImplementedError` until ROADMAP queue 1 item 10 brings them, as are
checkpoints, fault plans, the governor and the communicator checks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import adjacency, tags
from ..core.mesh import Mesh, compact, compact_aux
from ..ops import analysis, interp, quality
from ..parallel import partition as partition_mod
from ..parallel.distribute import (
    ShardComm,
    assign_global_ids,
    merge_shards,
    rebuild_comm,
    split_mesh,
    stack_meshes,
    unstack_mesh,
)
from .adapt import (
    AdaptOptions,
    MemoryBudgetError,
    _check_budget,
    _sweep_body,
    pad_changed,
    stacked_frontier,
    adapt as adapt_single,
    check_supported,
    default_mem_budget_mb,
    estimate_target_ntet,
    local_hausd_table,
    prepare_metric,
    resolve_hausd,
    run_sweep_loop,
    validate,
)

@dataclasses.dataclass
class DistOptions(AdaptOptions):
    """Distributed controls on top of the adaptation options. The
    balancing parameters of the JAX package's `DistOptions` come with
    the balancing (ROADMAP queue 1, item 10)."""

    nparts: int = 8
    # -nobalance: no resharding between iterations; frozen bands stay
    # frozen for all niter. True is the only mode of this slice when
    # nparts > 1; the balancing (ROADMAP queue 1, item 10) brings False
    nobalancing: bool = False
    # minimum elements per shard: a smaller mesh is first grown on one
    # shard, so frozen interfaces stay a thin fraction of each shard
    min_shard_elts: int = 256


def _refuse_balancing(opts: DistOptions) -> None:
    if not opts.nobalancing and opts.nparts > 1:
        raise NotImplementedError(
            "distributed runs rebalance between iterations unless "
            "nobalancing=True (CLI -nobalance): ROADMAP queue 1, item 10 "
            "(interface displacement and graph balancing, "
            "parallel/migrate.py) brings the balancing")


# ---------------------------------------------------------------------------
# shard-list utilities (per-shard meshes of uniform capacities)
# ---------------------------------------------------------------------------

def stacked_counts(shards: List[Mesh]) -> tuple:
    """Largest live (vertex, tet, tria, edge) counts over the shards."""
    cnt = torch.stack([torch.stack([m.vmask.sum(), m.tmask.sum(),
                                    m.trmask.sum(), m.edmask.sum()])
                       for m in shards]).max(dim=0).values
    return tuple(int(v) for v in cnt.tolist())


def _caps(shards: List[Mesh]) -> tuple:
    m = shards[0]
    return m.pcap, m.tcap, m.fcap, m.ecap


def grow_stacked(shards: List[Mesh], pcap=None, tcap=None, fcap=None,
                 ecap=None) -> List[Mesh]:
    """Grow the capacities of every shard (`Mesh.with_capacity`)."""
    return [m.with_capacity(pcap, tcap, fcap, ecap) for m in shards]


def _presize_for_target(shards: List[Mesh],
                        opts: AdaptOptions) -> List[Mesh]:
    """Pre-size capacities for the predicted unit mesh of the largest
    shard; skipped when that would exceed the memory budget (real growth
    happens between sweeps)."""
    est_ne = int(max(estimate_target_ntet(m) for m in shards) * 1.35) + 64
    pcap, tcap, fcap, ecap = _caps(shards)
    if est_ne > tcap:
        want = (max(pcap, est_ne // 5 + 64), est_ne,
                max(fcap, est_ne // 4 + 64), max(ecap, est_ne // 16 + 64))
        try:
            _check_budget(shards[0], opts, *want)
        except MemoryBudgetError:
            return shards
        shards = grow_stacked(shards, *want)
    return shards


def ensure_capacity_stacked(shards: List[Mesh],
                            opts: AdaptOptions) -> List[Mesh]:
    """Grow every shard when any shard crosses the utilization trigger
    (capacities stay uniform)."""
    g = opts.grow_factor

    def target(n, cap):
        if n > opts.grow_trigger * cap:
            return max(int(n * g) + 8, int(cap * g))
        return cap

    caps = _caps(shards)
    want = tuple(target(n, c) for n, c in zip(stacked_counts(shards), caps))
    if want != caps:
        _check_budget(shards[0], opts, *want)
        shards = grow_stacked(shards, *want)
    return shards


# ---------------------------------------------------------------------------
# the remesh phase on every shard
# ---------------------------------------------------------------------------

def _vsweep(shards: List[Mesh], ecap: int, opts: AdaptOptions, hausd,
            frontier=None):
    """One sweep of every shard, with the split-dominant skip off (a
    per-shard skip would make the shards' programs differ). Returns
    (shards, per-shard SweepStats list), and with `frontier` (a list of
    per-shard Frontiers with shared `dirty`/`adja_ok`) the successor
    frontiers, whose `dirty` is the largest and `adja_ok` the AND over
    the shards: a stricter level is exact for every shard."""
    kw = dict(noinsert=opts.noinsert, noswap=opts.noswap, nomove=opts.nomove,
              nosurf=opts.nosurf, hausd=hausd, phase_skip=False)
    out, stats, frs = [], [], []
    for i, m in enumerate(shards):
        if frontier is None:
            m, s = _sweep_body(m, ecap, **kw)
        else:
            m, s, f = _sweep_body(m, ecap, frontier=frontier[i], **kw)
            frs.append(f)
        out.append(m)
        stats.append(s)
    if frontier is None:
        return out, stats
    dirty = max(f.dirty for f in frs)
    adja_ok = all(f.adja_ok for f in frs)
    return out, stats, [f._replace(dirty=dirty, adja_ok=adja_ok)
                        for f in frs]


def _rec_from_stats(shards: List[Mesh], stats) -> dict:
    """One history record from the per-shard SweepStats: sums over the
    shards, the largest unique-edge count, any capped split, and the
    per-shard live tets (one host sync)."""
    cols = ("nsplit", "ncollapse", "nswap", "nmoved", "n_unique",
            "split_capped", "n_active", "n_len_unit", "n_len_edges")
    tab = torch.stack([torch.stack([getattr(x, c) for x in stats]).to(
        torch.int64) for c in cols] + [
        torch.stack([m.tmask.sum() for m in shards]),
        torch.stack([m.vmask.sum() for m in shards])])
    v = dict(zip(cols + ("shard_ne", "shard_np"), np.asarray(tab.tolist())))
    na, nu, shard_ne = v["n_active"], v["n_unique"], v["shard_ne"]
    n_len_unit, n_len_edges = int(v["n_len_unit"].sum()), \
        int(v["n_len_edges"].sum())
    return dict(
        nsplit=int(v["nsplit"].sum()), ncollapse=int(v["ncollapse"].sum()),
        nswap=int(v["nswap"].sum()), nmoved=int(v["nmoved"].sum()),
        ne=int(shard_ne.sum()), np=int(v["shard_np"].sum()),
        n_unique=int(nu.max()), capped=bool(v["split_capped"].any()),
        n_active=int(na.sum()),
        active_fraction=round(float(na.sum()) / max(int(nu.sum()), 1), 6),
        n_len_unit=n_len_unit, n_len_edges=n_len_edges,
        in_band=round(n_len_unit / max(n_len_edges, 1), 6),
        shard_active=[round(float(a) / max(int(u), 1), 4)
                      for a, u in zip(na.tolist(), nu.tolist())],
        shard_ne=[int(x) for x in shard_ne.tolist()],
        imbalance=round(float(shard_ne.max())
                        / max(float(shard_ne.mean()), 1.0), 4),
    )


def _drained_rec(shards: List[Mesh], history: List[dict]) -> dict:
    """Zero-op record of a skipped (drained-frontier) phase, with the
    keys of a real record: the unique-edge count and unit-band share
    carry forward from the last measured sweep."""
    last_nu = next((int(r["n_unique"]) for r in reversed(history)
                    if r.get("n_unique")), 0)
    last_band = next((float(r["in_band"]) for r in reversed(history)
                      if "in_band" in r), None)
    cnt = torch.stack([torch.stack([m.tmask.sum(), m.vmask.sum()])
                       for m in shards]).tolist()
    shard_ne = np.asarray([c[0] for c in cnt], np.int64)
    rec = dict(
        nsplit=0, ncollapse=0, nswap=0, nmoved=0,
        ne=int(shard_ne.sum()), np=int(sum(c[1] for c in cnt)),
        n_unique=last_nu, capped=False, n_active=0,
        active_fraction=0.0, shard_active=[0.0] * len(shards),
        shard_ne=[int(x) for x in shard_ne.tolist()],
        imbalance=round(float(shard_ne.max())
                        / max(float(shard_ne.mean()), 1.0), 4),
        skipped=True,
    )
    if last_band is not None:
        rec["in_band"] = last_band
    return rec


def _frontier_stale(fr, shards: List[Mesh], ecap: int) -> bool:
    """Capacity growth or an edge-cap event changed the table shapes:
    the carried frontier is re-seeded (its changed masks survive, padded;
    the tables restart stale)."""
    f, m = fr[0], shards[0]
    return (f.changed.shape[0] != m.pcap or f.tables[0].shape[0] != ecap
            or f.tables[2].shape[0] != m.tcap)


def remesh_phase(shards: List[Mesh], opts: AdaptOptions,
                 emult: List[float], history: List[dict], it: int,
                 hausd, fr0=None):
    """Operator sweeps to convergence on every shard: the shared
    `run_sweep_loop` engine with records summed over the shards.

    With `opts.frontier`, `fr0` is the iteration's carried active set
    (per-shard [PC] bool masks; None = all active, the full-table
    sweep): the first sweep gates on its one-ring closure, and a drained
    carry skips the sweeps outright (an empty-frontier sweep is the
    identity). Returns (shards, changed masks | None)."""
    use_fr = bool(opts.frontier)
    if use_fr and fr0 is not None:
        if int(torch.stack([c.sum() for c in fr0]).sum()) == 0:
            rec = _drained_rec(shards, history)
            rec.update(iter=it, sweep=0)
            history.append(rec)
            return shards, fr0
    fr_cell: list = [None]

    def sweep_fn(s, ecap):
        if not use_fr:
            s, stats = _vsweep(s, ecap, opts, hausd)
            return s, _rec_from_stats(s, stats)
        fr = fr_cell[0]
        if fr is None or _frontier_stale(fr, s, ecap):
            chg = ([f.changed for f in fr] if fr is not None else fr0)
            fr = stacked_frontier(
                s, ecap, None if chg is None else pad_changed(chg, s[0].pcap))
        s, stats, fr_cell[0] = _vsweep(s, ecap, opts, hausd, frontier=fr)
        return s, _rec_from_stats(s, stats)

    shards = run_sweep_loop(
        shards, opts, emult, history, it,
        ensure_fn=lambda s: ensure_capacity_stacked(s, opts),
        tcap_fn=lambda s: s[0].tcap, sweep_fn=sweep_fn)
    if not use_fr:
        return shards, None
    if fr_cell[0] is not None:
        chg = [f.changed for f in fr_cell[0]]
    elif fr0 is not None:
        chg = fr0
    else:
        chg = [torch.ones(m.pcap, dtype=torch.bool, device=m.device)
               for m in shards]
    return shards, pad_changed(chg, shards[0].pcap)


def interp_phase(shards: List[Mesh], old: List[Mesh],
                 opts: AdaptOptions | None = None) -> List[Mesh]:
    """Interpolation of every shard from its pre-remesh snapshot
    (`interp.interp_stacked`). The wedge threshold of the surface path
    follows the feature angle (-ar); without feature detection (-nr)
    nothing counts as cross-ridge."""
    cw = (-1.0 if opts is None or opts.angle is None
          else math.cos(math.radians(opts.angle)))
    return interp.interp_stacked(shards, old, cos_wedge=cw)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _finish_dist_info(shards: List[Mesh], history: List[dict], h_in,
                      status) -> dict:
    """Exit bookkeeping: the world quality histogram and the world
    edge-length histogram (per-shard unique edges, merged)."""
    h_out = quality.merge_stacked_histograms(
        [quality.quality_histogram(m) for m in shards])
    ecap = int(shards[0].tcap * 1.7) + 64
    len_out = quality.merge_stacked_length_stats(
        [quality.mesh_length_stats(m, ecap) for m in shards])
    return dict(history=history, qual_in=h_in, qual_out=h_out,
                len_out=len_out, status=status)


def adapt_distributed(mesh: Mesh, opts: Optional[DistOptions] = None,
                      device=None):
    """Adapt a centralized mesh on `opts.nparts` shards on `device`
    (default: the GPU — raises when there is none).

    Preprocess (adjacency, analysis, metric) → grow single-shard while
    the mesh is smaller than `nparts * min_shard_elts` → Morton
    partition with metric weights → split → `niter` × [remesh with
    frozen interfaces → interpolate] → global numbering. Returns
    (stacked Mesh, ShardComm, info); `merge_adapted` gives the
    centralized output."""
    device = resolve_device(device)
    opts = opts or DistOptions()
    check_supported(opts)
    _refuse_balancing(opts)
    if mesh.fields.shape[1] + mesh.ls.shape[1] + mesh.disp.shape[1]:
        raise NotImplementedError(
            "meshes carrying solution fields, a level-set or a "
            "displacement are not ported yet: ROADMAP queue 1, item 11 "
            "(interp_fields_only, level set)")
    mesh = mesh.to(device)
    if opts.mem_budget_mb is None:
        derived = default_mem_budget_mb(device)
        if derived is not None:
            opts = dataclasses.replace(opts, mem_budget_mb=derived)
    nparts = opts.nparts

    mesh = adjacency.build_adjacency(mesh)
    mesh = analysis.analyze(mesh, ang=opts.angle, opnbdy=opts.opnbdy)
    mesh = prepare_metric(mesh, opts, int(mesh.tcap * 1.6) + 64)
    hausd = local_hausd_table(mesh, opts, resolve_hausd(mesh, opts))
    h_in = quality.quality_histogram(mesh)

    # a mesh too small for nparts shards is grown single-shard first
    while int(mesh.ntet) < nparts * opts.min_shard_elts \
            and not opts.noinsert:
        pre_opts = dataclasses.replace(opts, niter=1, hgrad=None)
        ne_before = int(mesh.ntet)
        mesh, _ = adapt_single(mesh, pre_opts, device=device)
        if int(mesh.ntet) <= ne_before:  # the metric is satisfied
            break

    # metric-aware weights balance the predicted output elements
    part = partition_mod.sfc_partition(
        mesh, nparts, partition_mod.metric_weights(mesh)).cpu().numpy()
    stacked, _ = split_mesh(mesh, part, nparts,
                            build_shard_adjacency=False)
    shards = _presize_for_target(unstack_mesh(stacked), opts)

    history: List[dict] = []
    shards, status = _iteration_loop(shards, opts, hausd, history)
    stacked = assign_global_ids(stack_meshes(shards))
    return (stacked, rebuild_comm(stacked),
            _finish_dist_info(shards, history, h_in, status))


def _iteration_loop(shards: List[Mesh], opts: DistOptions, hausd,
                    history: List[dict]):
    """The `niter` remesh/interpolate iterations. Each is validated at
    its boundary; a numeric, capacity or budget failure (ValueError,
    RuntimeError, FloatingPointError, OverflowError) rolls back to the
    last good state and ends the run with LOWFAILURE. A kernel that
    fails to build or launch raises `KernelError`, which is none of
    these and ends the run. With `opts.frontier` the changed masks are
    carried from one iteration to the next (None = all active at the
    start and after a rollback, whose shards predate the carry).
    Returns (shards, status)."""
    emult = [1.6]
    status = tags.ReturnStatus.SUCCESS
    # every op returns new tensors, so the shards of the last good
    # iteration stay as they were
    last_good = shards
    fr_carry = None
    for it in range(opts.niter):
        try:
            shards, fr_carry = _one_iteration(shards, opts, hausd, history,
                                              it, emult, fr_carry)
            validate(shards, opts, it)
        except NotImplementedError:
            raise
        except (FloatingPointError, ValueError, RuntimeError,
                OverflowError) as e:
            history.append(dict(iter=it, failure=str(e),
                                error=type(e).__name__))
            shards = last_good
            fr_carry = None
            status = tags.ReturnStatus.LOWFAILURE
            break
        last_good = shards
    return shards, status


def _one_iteration(shards: List[Mesh], opts: DistOptions, hausd,
                   history: List[dict], it: int, emult, fr=None):
    """Remesh every shard with frozen interfaces, then interpolate the
    metric from the pre-remesh snapshot. The frontier carry `fr` goes
    through the compaction with the shards. Returns (shards, carry)."""
    _refuse_balancing(opts)
    # the snapshot shares tensors with the shards: the remesh returns
    # new ones and leaves its inputs as they were
    old = [adjacency.build_adjacency(m) for m in shards]
    shards, fr = remesh_phase(shards, opts, emult, history, it, hausd,
                              fr0=fr)
    if fr is None:
        shards = [compact(m) for m in shards]
    else:
        packed = [compact_aux(m, c) for m, c in zip(shards, fr)]
        shards, fr = [p[0] for p in packed], [p[1] for p in packed]
    return interp_phase(shards, old, opts), fr


def merge_adapted(stacked: Mesh, comm: ShardComm) -> Mesh:
    """Centralized output: the adapted shards merged into one Mesh
    (global ids must be assigned, as `adapt_distributed` does)."""
    return merge_shards(stacked, comm)
