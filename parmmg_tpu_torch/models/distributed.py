"""Distributed remeshing: shards with interfaces frozen within an
iteration and displaced between iterations, on one device or across the
ranks of a `torch.distributed` world.

Counterpart of `parmmg_tpu/models/distributed.py`: the mesh is
partitioned along a Morton curve into `nparts` shards of uniform
capacities, carried as a list of per-shard `Mesh`es; every iteration
remeshes each shard's interior with its PARBDY interfaces frozen,
re-interpolates the metric (and the solution fields, level set and
displacement the mesh carries) from the pre-remesh snapshot and then,
unless `nobalancing` (`-nobalance`), rebalances: the shards are stacked
(leading shard axis, as the JAX package's stacked mesh), tets are
recolored by interface displacement (`ifc_layers` layers of advancing
front) or, on the last iteration and in graph mode, by a global weighted
Morton cut, and the tets that change color migrate to their new shard
(`parallel/migrate.py`), so the bands frozen in one iteration are
interior in the next. A displaced partition skewed past `grps_ratio`, a
`BalancePolicy` decision or repeated capacity misses fall back to a full
re-cut (`_rebalance_full`). At the end the new vertices get global ids
and `merge_adapted` joins the shards into one centralized mesh.

Each sweep runs the single-shard `_sweep_body` once per shard (the JAX
package vmaps it over the shard axis, which gives the same per-shard
results). What the shards share stays shared: the unique-edge cap from
the common tet capacity, growth to the largest shard's need, no
split-dominant phase skip, the convergence rule on the record summed
over shards, and, with frontier sweeps, the tables' staleness level
(the largest over the shards) and adjacency validity (all shards). The
per-shard frontier masks are carried from sweep to sweep and, through
the compaction and the migration (as global ids), from one iteration to
the next; a drained carry skips the iteration's sweeps.

Under a world of ranks (`parallel/multihost.py`, the env contract) every
rank runs `adapt_distributed` on the same input and holds the full
state: the host phases are replicated, and only the sweeps split, each
rank sweeping the shards it owns with one gather of the world's rows a
sweep (`remesh_phase`, the JAX package's shard-local dispatch; the port
has no fused SPMD program, so it is the phase at every tet capacity).
The result is that of one process bit for bit. Whether an iteration
rolls back is put to a vote of the world, so the ranks roll back
together; a failed collective raises `multihost.PeerLostError`, which
no rollback absorbs.

`adapt_stacked_input` is the entry for a mesh that comes distributed
(`-distributed-input`, per-rank files read by
`io.medit.load_mesh_distributed`): per-shard analysis, the cross-shard
feature pass, the metric and the same iterations. With
`DistOptions.check_comm` every iteration rebuilds the node tables and
runs `parallel.chkcomm.assert_comm_ok` after the interpolation.

Not ported: checkpoints and resume, fault plans, telemetry and the
governor, refused with `NotImplementedError` naming their ROADMAP items.
A `CapacityError` that escapes an iteration rolls it back as any other
`RuntimeError` does (the JAX package's iteration-level grow-and-retry
comes with the failsafe layer).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import adjacency, tags
from ..core.mesh import LEAVES, Mesh, compact, compact_aux
from ..ops import analysis, interp, quality
from ..parallel import chkcomm, multihost
from ..parallel import migrate as migrate_mod
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
    CapacityError,
    MemoryBudgetError,
    SweepStats,
    _check_budget,
    _sweep_body,
    pad_changed,
    adapt as adapt_single,
    check_supported,
    default_mem_budget_mb,
    empty_frontier,
    estimate_target_ntet,
    local_hausd_table,
    prepare_metric,
    resolve_hausd,
    run_sweep_loop,
    validate,
)

# redistribution modes (the JAX package's REDISTRIBUTION_* constants)
REDISTRIBUTION_GRAPH_BALANCING = 0
REDISTRIBUTION_IFC_DISPLACEMENT = 1


@dataclasses.dataclass
class DistOptions(AdaptOptions):
    """Distributed controls on top of the adaptation options (the JAX
    package's `DistOptions`)."""

    nparts: int = 8
    # -nobalance: no resharding between iterations; frozen bands stay
    # frozen for all niter
    nobalancing: bool = False
    # advancing-front displacement depth per iteration (-nlayers)
    ifc_layers: int = 2
    # max shard-size imbalance (max/mean) before a full SFC re-cut
    # replaces the displaced partition (the CLI's -groups-ratio gives 2.0)
    grps_ratio: float = 2.5
    # between-iteration redistribution mode; graph mode recomputes a
    # global weighted Morton cut every iteration
    # (partition.stacked_graph_colors) instead of advancing fronts. The
    # last iteration always takes the graph cut.
    repartitioning: int = REDISTRIBUTION_IFC_DISPLACEMENT
    # rebuild the node tables and check every communicator invariant
    # (`parallel.chkcomm.assert_comm_ok`) after each interpolation
    check_comm: bool = False
    # minimum elements per shard: a smaller mesh is first grown on one
    # shard, so frozen interfaces stay a thin fraction of each shard
    min_shard_elts: int = 256


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

def _imbalance(shard_ne: np.ndarray) -> float:
    """Largest over mean live tets of the shards, to 4 places."""
    return round(float(shard_ne.max()) / max(float(shard_ne.mean()), 1.0),
                 4)


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
        imbalance=_imbalance(shard_ne),
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
        imbalance=_imbalance(shard_ne),
        skipped=True,
    )
    if last_band is not None:
        rec["in_band"] = last_band
    return rec


def _pad_changed1(changed, pcap: int):
    """One shard's `pad_changed`: [PC_old] -> [PC] (growth appends
    slots; ids are stable, the new tail is inactive)."""
    return pad_changed([changed.to(torch.bool)], pcap)[0]


def _frontier_stale(fr, m: Mesh, ecap: int) -> bool:
    """Capacity growth or an edge-cap event changed the shard's table
    shapes: its carried frontier is re-seeded (the changed mask
    survives, padded; the tables restart stale)."""
    return (fr.changed.shape[0] != m.pcap or fr.tables[0].shape[0] != ecap
            or fr.tables[2].shape[0] != m.tcap)


# a rank's failure that the iteration loop rolls back: numeric, capacity
# or budget (`CapacityError` and a card's out-of-memory error are
# RuntimeErrors)
_ABSORBED = (FloatingPointError, ValueError, RuntimeError, OverflowError)
# the bits of a vote of the world: some rank failed; some rank has left
# the iteration (its vote is the iteration's last)
_FAILED, _ENDED = 1, 2


class PeerFailure(RuntimeError):
    """Another rank of the world failed in this iteration: what the ranks
    that did not fail raise, so that the world rolls back together."""


def _agreed(fn, tag: str):
    """`fn()`, this rank's own work before the collective `tag`, its
    failure put to a vote of the world first: every rank raises at this
    point (its own error, or `PeerFailure`) or none does. The error
    raised carries `ended`: a peer's vote was its iteration's last, so
    this one ends the iteration here too. In one process, `fn()`."""
    if not multihost.is_multiprocess():
        return fn()
    err = out = None
    try:
        out = fn()
    except multihost.PeerLostError:
        raise
    except _ABSORBED as e:
        err = e
    flags = multihost.agree_flags(_FAILED if err is not None else 0,
                                  tag=f"{tag}-vote")
    if flags:
        if err is None:
            err = PeerFailure(f"a peer rank failed before '{tag}'")
        err.ended = bool(flags & _ENDED)
        raise err
    return out


def _iteration_vote(err):
    """The world's verdict on an iteration, by one vote at its end
    (unless a vote inside it ended it already): this rank's failure
    `err`, `PeerFailure` where only another rank failed, or None."""
    if not multihost.is_multiprocess() or getattr(err, "ended", False):
        return err
    flags = multihost.agree_flags(
        _ENDED | (_FAILED if err is not None else 0), tag="iteration-vote")
    if flags & _FAILED and err is None:
        return PeerFailure("a peer rank failed in this iteration")
    return err


def remesh_phase(shards: List[Mesh], opts: AdaptOptions,
                 emult: List[float], history: List[dict], it: int,
                 hausd, fr0=None):
    """Operator sweeps to convergence on every shard: the shared
    `run_sweep_loop` engine with records summed over the shards (the JAX
    package's `_remesh_phase_shardlocal`; the port has no fused SPMD
    program, so this is the phase at every tet capacity).

    Each sweep runs `_sweep_body` on the shards this rank owns
    (`shard.owned_shards`: all of them in one process), with the
    split-dominant skip off (a per-shard skip would make the shards'
    programs differ), then joins the world's shards and sweep stats by
    one `multihost.gather_stacked` (the identity in one process), so
    every rank holds the full state again. Host control flow stays
    replicated: capacity growth, convergence and the frontier's restarts
    read the gathered state, and each sweep's record is built from the
    gathered stats. Where some rank would own no shard (more ranks than
    shards), every rank sweeps every shard and nothing is gathered. A
    rank's failure in its own sweeps is put to a vote before the gather
    (`_agreed`), so the world raises, and rolls back, together.

    With `opts.frontier`, `fr0` is the iteration's carried active set
    (per-shard [PC] bool masks; None = all active, the full-table
    sweep): the first sweep gates on its one-ring closure, and a drained
    carry skips the sweeps outright (an empty-frontier sweep is the
    identity). Each shard's exit staleness level and adjacency validity
    ride the sweep's gather, and every shard takes the world's (the
    largest level, all valid): a stricter level is exact for every
    shard. The JAX package keeps them per shard, which leaves the meshes
    as they are but not the stats: a shard that reuses its tables
    reports their carried `n_unique` where a fresh rebuild counts anew,
    and `shard_active`, which the `BalancePolicy` reads, follows it
    (ROADMAP queue 3). The changed masks are gathered once more at the
    end. Returns (shards, changed masks | None)."""
    from ..parallel.shard import owned_shards

    if opts.frontier and fr0 is not None:
        if int(torch.stack([c.sum() for c in fr0]).sum()) == 0:
            rec = _drained_rec(shards, history)
            rec.update(iter=it, sweep=0)
            history.append(rec)
            return shards, fr0
    D = len(shards)
    everyone = multihost.world_size() > D
    owned = tuple(range(D)) if everyone else owned_shards(D)
    use_fr = bool(opts.frontier)
    frs: dict = {}
    kw = dict(noinsert=opts.noinsert, noswap=opts.noswap, nomove=opts.nomove,
              nosurf=opts.nosurf, hausd=hausd, phase_skip=False)

    def gather(rows_fn, tag):
        rows = _agreed(rows_fn, tag)
        return rows if everyone else multihost.gather_stacked(rows, D,
                                                              tag=tag)

    def sweep_owned(s, ecap):
        rows = []
        for i in owned:
            m = s[i]
            if use_fr:
                fr = frs.get(i)
                if fr is None or _frontier_stale(fr, m, ecap):
                    if fr is not None:
                        # mid-loop growth: the changed mask survives,
                        # the tables restart stale
                        chg = _pad_changed1(fr.changed, m.pcap)
                    elif fr0 is not None:
                        chg = _pad_changed1(fr0[i], m.pcap)
                    else:
                        chg = None  # full frontier: the full sweep
                    fr = empty_frontier(m, ecap)
                    if chg is not None:
                        fr = fr._replace(changed=chg)
                m, stats, frs[i] = _sweep_body(m, ecap, frontier=fr, **kw)
            else:
                m, stats = _sweep_body(m, ecap, **kw)
            row = tuple(getattr(m, k) for k in LEAVES) + tuple(stats)
            if use_fr:
                row += (torch.tensor([frs[i].dirty, frs[i].adja_ok],
                                     dtype=torch.int32, device=m.device),)
            rows.append(row)
        return rows

    def sweep_fn(s, ecap):
        rows = gather(lambda: sweep_owned(s, ecap), "sweep")
        nl, ns = len(LEAVES), len(SweepStats._fields)
        if use_fr:
            # the world's staleness level and adjacency validity
            lv = torch.stack([r[-1] for r in rows]).tolist()
            dirty, adja_ok = max(x[0] for x in lv), all(x[1] for x in lv)
            for i in owned:
                frs[i] = frs[i]._replace(dirty=dirty, adja_ok=adja_ok)
        out = [s[i].replace(**dict(zip(LEAVES, r[:nl])))
               for i, r in enumerate(rows)]
        return out, _rec_from_stats(out, [SweepStats(*r[nl:nl + ns])
                                          for r in rows])

    shards = run_sweep_loop(
        shards, opts, emult, history, it,
        ensure_fn=lambda s: ensure_capacity_stacked(s, opts),
        tcap_fn=lambda s: s[0].tcap, sweep_fn=sweep_fn)
    if not use_fr:
        return shards, None
    pcap = shards[0].pcap
    if frs:
        chg = [r[0] for r in gather(
            lambda: [(_pad_changed1(frs[i].changed, pcap),) for i in owned],
            "changed")]
    elif fr0 is not None:
        chg = fr0
    else:
        chg = [torch.ones(m.pcap, dtype=torch.bool, device=m.device)
               for m in shards]
    return shards, pad_changed(chg, pcap)


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
    frozen interfaces → interpolate → rebalance] → global numbering.
    Returns (stacked Mesh, ShardComm, info); `merge_adapted` gives the
    centralized output. `info["balance"]` holds one row per iteration
    whose rebalancing moved cells or re-cut: trigger, cells moved,
    imbalance (max/mean) before and after, and the block's wall time."""
    device = resolve_device(device)
    opts = opts or DistOptions()
    check_supported(opts)
    mesh = mesh.to(device)
    opts = _with_budget(opts, device)
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
    balance: List[dict] = []
    shards, status, icap = _iteration_loop(shards, opts, hausd, history,
                                           balance)
    stacked = assign_global_ids(stack_meshes(shards))
    info = _finish_dist_info(shards, history, h_in, status)
    info["balance"] = balance
    return stacked, rebuild_comm(stacked, icap), info


def _with_budget(opts: DistOptions, device) -> DistOptions:
    """`opts` with the memory budget derived from the device when unset."""
    if opts.mem_budget_mb is None:
        derived = default_mem_budget_mb(device)
        if derived is not None:
            opts = dataclasses.replace(opts, mem_budget_mb=derived)
    return opts


def adapt_stacked_input(stacked: Mesh, comm: Optional[ShardComm],
                        opts: Optional[DistOptions] = None, device=None):
    """Adapt a mesh that comes distributed: a stacked mesh with PARBDY
    interface tags and `vglob` set on the interface vertices, as
    `parallel.distribute.stack_loaded_shards` (or
    `io.medit.load_mesh_distributed`) builds it from per-rank files, on
    `device` (default: the GPU — raises when there is none).

    Per-shard analysis, the cross-shard feature agreement, the metric,
    the hausd of the global bounding box, then the iterations of
    `adapt_distributed` (balancing between them unless `nobalancing`),
    with the node tables sized like the given `comm`'s. `nparts` is the
    number of shards. Returns (stacked, comm, info) like
    `adapt_distributed`."""
    device = resolve_device(device)
    opts = opts or DistOptions()
    check_supported(opts)
    opts = _with_budget(dataclasses.replace(
        opts, nparts=stacked.vert.shape[0]), device)
    stacked = stacked.to(device)

    ecap0 = int(stacked.tet.shape[1] * 1.6) + 64
    shards = [analysis.analyze(m, ang=opts.angle, opnbdy=opts.opnbdy)
              for m in unstack_mesh(stacked)]
    if opts.angle is not None:
        shards = analysis.cross_shard_features(shards, ang=opts.angle)
    shards = [prepare_metric(m, opts, ecap0) for m in shards]
    fc, ec = max(m.fcap for m in shards), max(m.ecap for m in shards)
    if any(m.fcap != fc or m.ecap != ec for m in shards):
        # the analysis grew some shards' tables: uniform capacities again
        shards = [m.with_capacity(fcap=fc, ecap=ec) for m in shards]
    stacked = stack_meshes(shards)
    if opts.hausd is not None:
        hausd = float(opts.hausd)
    else:  # the bounding box of all shards
        w = stacked.vmask[..., None]
        lo = torch.where(w, stacked.vert, torch.inf).amin(dim=(0, 1))
        hi = torch.where(w, stacked.vert, -torch.inf).amax(dim=(0, 1))
        diag = float(torch.linalg.norm(hi - lo))
        hausd = 0.01 * (diag if diag > 0 else 1.0)
    hausd = local_hausd_table(stacked, opts, hausd)
    h_in = quality.merge_stacked_histograms(
        [quality.quality_histogram(m) for m in shards])

    shards = _presize_for_target(shards, opts)
    history: List[dict] = []
    balance: List[dict] = []
    # the given tables' width (interfaces only shrink while frozen), so
    # the rebuilt tables keep one shape across iterations
    shards, status, icap = _iteration_loop(
        shards, opts, hausd, history, balance,
        icap0=None if comm is None else comm.icap)
    stacked = assign_global_ids(stack_meshes(shards))
    info = _finish_dist_info(shards, history, h_in, status)
    info["balance"] = balance
    return stacked, rebuild_comm(stacked, icap), info


def _balance_policy(opts: DistOptions):
    """The run's closed-loop balancer (one instance: its state is the
    hysteresis), or None when the band is off or nothing rebalances."""
    if opts.nobalancing or opts.nparts <= 1:
        return None
    band = migrate_mod.resolve_balance_band(opts)
    return None if band is None else migrate_mod.BalancePolicy(band)


def _iteration_loop(shards: List[Mesh], opts: DistOptions, hausd,
                    history: List[dict], balance: List[dict],
                    icap0: Optional[int] = None):
    """The `niter` remesh/interpolate/rebalance iterations. Each is
    validated at its boundary; a numeric, capacity or budget failure
    (ValueError, RuntimeError — `CapacityError` included —,
    FloatingPointError, OverflowError) rolls back to the last good state
    and ends the run with LOWFAILURE. A kernel that fails to build or
    launch raises `KernelError`, which is none of these and ends the
    run. With `opts.frontier` the changed masks are carried from one
    iteration to the next (None = all active at the start and after a
    rollback, whose shards predate the carry). `icap0` is the node
    tables' width to start from (None: sized to the need). Returns
    (shards, status, icap: the width the last rebuild left, or None)."""
    emult = [1.6]
    status = tags.ReturnStatus.SUCCESS
    policy = _balance_policy(opts)
    # every op returns new tensors, so the shards of the last good
    # iteration stay as they were
    last_good = shards
    fr_carry = None
    icap = icap0
    for it in range(opts.niter):
        err = None
        try:
            shards, icap, fr_carry = _one_iteration(
                shards, opts, hausd, history, it, emult, icap, fr_carry,
                policy, balance)
            validate(shards, opts, it)
        except (NotImplementedError, multihost.PeerLostError):
            # a lost peer cannot be rolled back around: the other ranks
            # would wait for this one in the next collective
            raise
        except _ABSORBED as e:
            err = e
        err = _iteration_vote(err)
        if err is not None:
            history.append(dict(iter=it, failure=str(err),
                                error=type(err).__name__))
            shards = last_good
            fr_carry = None
            icap = None
            status = tags.ReturnStatus.LOWFAILURE
            break
        last_good = shards
    return shards, status, icap


def _one_iteration(shards: List[Mesh], opts: DistOptions, hausd,
                   history: List[dict], it: int, emult, icap=None,
                   fr=None, policy=None, balance=None):
    """Remesh every shard with frozen interfaces, interpolate the metric
    from the pre-remesh snapshot, then rebalance (unless -nobalance).
    The frontier carry `fr` goes through the compaction and the
    migration with the shards. Returns (shards, icap, carry)."""
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
    shards = interp_phase(shards, old, opts)
    if opts.check_comm:
        # the node tables rebuilt from the persistent global ids, then
        # every communicator invariant
        stacked = stack_meshes(shards)
        comm = rebuild_comm(stacked, icap)
        icap = comm.icap
        chkcomm.assert_comm_ok(stacked, comm, tol=1e-6)
    if not opts.nobalancing and opts.nparts > 1:
        stacked, icap, fr = _rebalance(
            stack_meshes(shards), opts, history, it, icap,
            None if fr is None else torch.stack(fr), policy, balance)
        shards = unstack_mesh(stacked)
        fr = None if fr is None else list(fr.unbind(0))
    return shards, icap, fr


def _grow(stacked: Mesh, color, **caps):
    """`grow_stacked` on a stacked mesh, with the [D,T] colors padded
    to the new tet capacity (-1: no color)."""
    stacked = stack_meshes(grow_stacked(unstack_mesh(stacked), **caps))
    pad = stacked.tet.shape[1] - color.shape[1]
    if pad:
        color = torch.nn.functional.pad(color, (0, pad), value=-1)
    return stacked, color


def _presize_stacked(stacked: Mesh, opts: DistOptions) -> Mesh:
    return stack_meshes(_presize_for_target(unstack_mesh(stacked), opts))


def _rebalance(stacked: Mesh, opts: DistOptions, history: List[dict],
               it: int, icap, fr, policy, balance):
    """The balancing block between iterations (the JAX package's
    `_one_iteration` from `if not opts.nobalancing and nparts > 1`):
    global ids and node tables, then graph colors (last iteration or
    graph mode) or interface-displacement colors, the contiguity repair
    when something moves, and the migration — or a full re-cut when the
    policy forces one, the new sizes pass `grps_ratio` or three
    capacity-sized attempts at the exchange fall short. `fr` is the [D,
    PC] frontier carry or None. Returns (stacked, icap, fr)."""
    nparts = opts.nparts
    last = it == opts.niter - 1
    decision = policy.evaluate(history, it) if policy is not None else None
    force_recut = bool(decision and decision.get("action") == "recut")
    t_bal = time.monotonic()
    stacked = assign_global_ids(stacked)
    comm = rebuild_comm(stacked, icap)
    stacked = migrate_mod.stacked_adjacency(stacked)
    graph_mode = (last or opts.repartitioning
                  == REDISTRIBUTION_GRAPH_BALANCING)
    if graph_mode:
        color = partition_mod.stacked_graph_colors(stacked, nparts)
    else:
        color = migrate_mod.displace_colors(stacked, comm, nparts,
                                            round_id=0,
                                            layers=opts.ifc_layers)
    cnts = migrate_mod.migration_counts(stacked, color, nparts).cpu().numpy()
    if cnts.max() > 0:
        # the front moved: reattach any component it pinched off
        color = migrate_mod.fix_contiguity(stacked, color, nparts)
        cnts = migrate_mod.migration_counts(stacked, color,
                                            nparts).cpu().numpy()
    fr_keys = None
    if fr is not None:
        # the active set as gid keys before the exchange: last sweep's
        # changed vertices, every vertex of a migrating cell and the
        # current interface bands (the displacement unfreezes them)
        par_pre = (stacked.vtag & tags.PARBDY) != 0
        fr_keys = migrate_mod.frontier_gid_keys(
            stacked,
            fr | par_pre | migrate_mod.migrating_vertices(stacked, color))
    moved_cells = int(cnts.sum())
    shard_ne = stacked.tmask.sum(dim=1).cpu().numpy()
    new_ne = shard_ne - cnts.sum(axis=1) + cnts.sum(axis=0)
    imb_pre = (decision or {}).get("imbalance")
    if imb_pre is None:
        imb_pre = _imbalance(shard_ne)
    trigger = "graph" if graph_mode else "displacement"
    if opts.verbose >= 2:
        print(f"  [balance] moved={moved_cells} new_ne={new_ne.tolist()}")
    recut = force_recut or (
        new_ne.max() > opts.grps_ratio * max(new_ne.mean(), 1.0))
    if recut:
        trigger = "balance-policy" if force_recut else "grps_ratio"
        if opts.verbose >= 2:
            print(f"  [balance] full re-cut ({trigger})")
    elif cnts.max() > 0:
        slot_cap = int(cnts.max()) + 8
        # headroom for the incoming entities before the exchange
        pc, tc = stacked.vert.shape[1], stacked.tet.shape[1]
        fc, ec = stacked.tria.shape[1], stacked.edge.shape[1]
        shard_np = stacked.vmask.sum(dim=1).cpu().numpy()
        shard_nf = stacked.trmask.sum(dim=1).cpu().numpy()
        inc = cnts.sum(axis=0)
        need_t = int((shard_ne + inc).max())
        need_p = int((shard_np + 4 * inc).max())
        need_f = int((shard_nf + 2 * inc).max())
        if need_t > 0.9 * tc or need_p > 0.9 * pc or need_f > 0.9 * fc:
            stacked, color = _grow(
                stacked, color, pcap=max(pc, int(need_p * 1.3) + 8),
                tcap=max(tc, int(need_t * 1.3) + 8),
                fcap=max(fc, int(need_f * 1.3) + 8),
                ecap=max(ec, int(need_t * 0.5) + 64))
        # bounded grow-and-retry on CapacityError, each retry sized by
        # the error's counts or overflow; repeated misses re-cut
        moved = None
        for att in range(3):
            try:
                moved = migrate_mod.migrate(stacked, color, nparts,
                                            slot_cap)
                break
            except CapacityError as e:
                history.append(dict(iter=it, phase="migrate",
                                    failure=str(e), error=type(e).__name__,
                                    recovered=True))
                if att == 2:
                    break
                if e.counts is not None:
                    slot_cap = int(e.counts.max()) + 8
                if e.overflow is not None:
                    over = np.maximum(np.asarray(e.overflow), 0).max(axis=0)
                    stacked, color = _grow(
                        stacked, color,
                        pcap=stacked.vert.shape[1] + int(over[0] * 1.3) + 8,
                        tcap=stacked.tet.shape[1] + int(over[1] * 1.3) + 8,
                        fcap=stacked.tria.shape[1] + int(over[2] * 1.3) + 8,
                        ecap=stacked.edge.shape[1] + int(over[3] * 1.3)
                        + 64)
        if moved is None:
            trigger, recut = "capacity-recut", True
        else:
            stacked = stack_meshes([compact(m) for m in unstack_mesh(moved)])
            stacked, comm = migrate_mod.retag_interfaces(stacked)
            icap = comm.icap
            stacked = _presize_stacked(stacked, opts)
            if fr is not None:
                # the carried gid set on the new owners, and the
                # post-exchange interface bands
                par_post = (stacked.vtag & tags.PARBDY) != 0
                fr = migrate_mod.frontier_from_gid_keys(stacked,
                                                        fr_keys) | par_post
    if recut:
        stacked, comm = _rebalance_full(stacked, comm, nparts)
        icap = None
        stacked = _presize_stacked(stacked, opts)
        # the merge and split rewrite every shard: the next iteration
        # starts from the full frontier
        fr = None if fr is None else torch.ones(
            (nparts, stacked.vert.shape[1]), dtype=torch.bool,
            device=stacked.device)
    if moved_cells or recut:
        balance.append(dict(
            it=it, trigger=trigger, cells=moved_cells,
            imbalance_pre=float(imb_pre),
            imbalance_post=_imbalance(
                stacked.tmask.sum(dim=1).cpu().numpy()),
            wall_s=round(time.monotonic() - t_bal, 4),
            reason=str((decision or {}).get("reason", ""))))
    return stacked, icap, fr


def _rebalance_full(stacked: Mesh, comm: ShardComm, nparts: int):
    """Full SFC re-cut through a merge and a split on the host: the
    fallback when the displaced partition skewed too far."""
    merged = adjacency.build_adjacency(merge_shards(stacked, comm))
    part = partition_mod.sfc_partition(
        merged, nparts, partition_mod.metric_weights(merged)).cpu().numpy()
    return split_mesh(merged, part, nparts, assume_adjacency=True,
                      build_shard_adjacency=False)


def merge_adapted(stacked: Mesh, comm: ShardComm) -> Mesh:
    """Centralized output: the adapted shards merged into one Mesh
    (global ids must be assigned, as `adapt_distributed` does)."""
    return merge_shards(stacked, comm)
