"""The distributed driver of the port on stacked shards
(`parmmg_tpu_torch.models.distributed`, `parallel/`) held against the JAX
package on the CPU, at f64.

The JAX side runs in child processes (`test_torch_ops.jax_side`),
compiled with XLA's backend optimisation level 0 as in
tests/test_torch_interp.py, and hands its inputs and outputs back as
numpy arrays.

- Partitioning and distribution: `sfc_partition` (unit and metric
  weights), `split_mesh` (every leaf of every shard and the `ShardComm`
  tables), `assign_global_ids`, `rebuild_comm` and `merge_shards`, on the
  analysed unit cube n=5 with a graded metric: all equal.
- Balancing between iterations (`parallel/migrate.py`,
  `partition.stacked_graph_colors`, the driver's `_rebalance_full`) on
  the split of that mesh, handed over from the JAX side: the
  displacement and graph colors, `fix_contiguity` (also on colors with
  islands), `migration_counts`, `migrate` then `compact` and
  `retag_interfaces` (every leaf and the `ShardComm` tables), the
  `CapacityError` of a too-small slot capacity (its counts) and the
  outcome of a migration without headroom, the frontier's gid-key round
  trip through the migration, and the full re-cut: all equal. The
  `BalancePolicy` decisions on the synthetic histories of
  tests/test_m24_balance.py equal the JAX policy's.
- The slice as a whole: `adapt_distributed(DistOptions(nparts=4,
  niter=2, min_shard_elts=16, max_sweeps=6))` on the unit cube n=5, with
  `nobalancing=True` once with `hsiz=0.18` and full-table sweeps and
  once with a graded iso metric and frontier sweeps (the per-shard
  frontier carried across sweeps and iterations), and with balancing on
  the graded metric with frontier sweeps (iteration 0 displaces the
  interfaces, the last one takes the graph cut, the frontier crosses the
  migration as global ids), against the live JAX run: the per-sweep
  integer history (the keys of tests/test_m1_remesh.py:258 and more,
  with `shard_ne`) and the histogram counts equal; the stacked and the
  merged mesh equal, vertices slot for slot with coordinates and metric
  within `_rtol` (5e-11), the live tets as a set (the reference's jit
  and op-by-op runs order them differently, see `_assert_leaves`);
  qmin/qavg within 5e-11 relative. Both graded cases carry a `(1, 3)`
  linear field, compared with JAX's (stacked and merged, within 5e-11).
- The library API (`api.ParMesh`): the centralized flows of
  tests/test_torch_adapt.py `api_flow` (the calls of
  tests/test_m6_api_io.py:19 and :50) against JAX's (`check_api`: staged
  f32 mesh and options exact, then integers equal and floats within
  5e-6), JAX's side in the `graded` child; the distributed getters (`api.ParMesh`:
  `get_vertex_glonum`, `get_triangle_glonum` with
  `distribute.assign_triangle_gids`, `get_node_communicator_owners`) on
  the balanced result equal JAX's on its own, exactly.
- The distributed workflow: `adapt_stacked_input`, called through
  `ParMesh.parmmglib_distributed`, with the
  communicator checks (balanced, frontier sweeps) on binary per-rank
  files of the graded mesh's 4-shard split, carrying the same field
  once loaded, against the live JAX run (the `input` case, compared as
  above); on that split (the distribute part's) the Medit files
  of both packages (centralized and per-rank, ASCII and binary, sols)
  are equal byte for byte, the readers and `stack_loaded_shards` (by
  stored global ids and by coordinate matching) give JAX's states and
  node tables, `cross_shard_features` / `cross_shard_singul` JAX's
  shards, the communicator checks JAX's reports, `renumber_sfc` JAX's
  mesh, and the halo combines their definition.
- The snapshot the interpolation reads is not touched by the remesh;
  `-nparts 4 -nobalance` and `-nparts 4 -balance 1.2 -nlayers 2` run
  through the CLI and write the API's merged mesh; `check_comm` runs
  and raises on incoherent tables; what stays unported is refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from parmmg_tpu_torch import __main__ as t_cli
from parmmg_tpu_torch import api as t_api
from parmmg_tpu_torch import kernels as t_kernels
from parmmg_tpu_torch.core import adjacency as t_adj
from parmmg_tpu_torch.core.mesh import LEAVES, Mesh
from parmmg_tpu_torch.io import medit as t_medit
from parmmg_tpu_torch.models import adapt as t_adapt
from parmmg_tpu_torch.models import distributed as t_dist
from parmmg_tpu_torch.ops import interp as t_interp
from parmmg_tpu_torch.parallel import distribute as t_distr
from parmmg_tpu_torch.parallel import migrate as t_mig
from parmmg_tpu_torch.parallel import partition as t_part
from parmmg_tpu_torch.utils import conformity, gen as t_gen
from test_torch_adapt import check_api, torch_api
from test_torch_ops import one_torch_thread, start_jax_side  # noqa: F401

RTOL = 5e-11
O0 = "--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false"
CASE = dict(nparts=4, nobalancing=True, frontier=False, niter=2,
            min_shard_elts=16, max_sweeps=6)
HIST_KEYS = ("nsplit", "ncollapse", "nswap", "nmoved", "ne", "np",
             "n_unique", "capped", "n_active", "n_len_unit", "n_len_edges",
             "in_band", "shard_ne", "iter", "sweep")
HISTO_INT = ("ne", "counts", "nbad", "ninverted", "worst_elt",
             "worst_shard")
COMM = ("comm_idx", "counts", "l2g", "owner")
CUMSUM_LENGTHS = (1, 15, 16, 17, 255, 256, 257, 4097, 70001)


CASES = ("hsiz", "graded", "balanced", "input")


def _case_options(case: str) -> dict:
    """DistOptions of a case: `hsiz` full-table, `graded` with frontier
    sweeps, `balanced` as `graded` with the balancing between
    iterations, `input` as `balanced` with the communicator checks, on
    the per-rank files of the graded mesh's split carrying the field
    (`adapt_stacked_input`)."""
    kw = dict(CASE)
    if case == "hsiz":
        kw["hsiz"] = 0.18
    else:
        kw["frontier"] = True
    if case in ("balanced", "input"):
        kw["nobalancing"] = False
    if case == "input":
        kw["check_comm"] = True
    return kw


def _graded(v):
    """The graded iso size of the tests: 0.1 + 0.15 x."""
    return (0.1 + 0.15 * v[:, 0])[:, None]


def _linear_fields(v):
    """The `(1, 3)` field the graded cases carry: 1 + x + 2y + 3z and
    (y, z, x). The split, the sweeps, the interpolation, the migration
    and the merge move it, and none of them changes the mesh for it."""
    return np.stack([1 + v[:, 0] + 2 * v[:, 1] + 3 * v[:, 2],
                     v[:, 1], v[:, 2], v[:, 0]], axis=-1)


def _put(out: dict, key: str, obj, names) -> None:
    for k in names:
        out[f"{key}/{k}"] = np.asarray(getattr(obj, k))


def _mesh(ref: dict, key: str, met_set=True) -> Mesh:
    return Mesh.from_jax_state({k: ref[f"{key}/{k}"] for k in LEAVES},
                               device="cpu", met_set=met_set)


# ---------------------------------------------------------------------------
# the JAX side (child process)
# ---------------------------------------------------------------------------


def _jax_distribute(out):
    import jax.numpy as jnp

    from parmmg_tpu.core import tags
    from parmmg_tpu.ops import analysis
    from parmmg_tpu.parallel import distribute, partition
    from parmmg_tpu.utils import gen

    import jax

    rng = np.random.default_rng(0)
    cumsum = jax.jit(jnp.cumsum)
    for n in CUMSUM_LENGTHS:
        x = rng.random(n).astype(np.float32)
        out[f"cs{n}/in"], out[f"cs{n}/out"] = x, np.asarray(cumsum(x))

    mesh = gen.unit_cube_mesh(5, dtype=jnp.float64)
    mesh = analysis.analyze(mesh.replace(
        met=jnp.asarray(_graded(np.asarray(mesh.vert))), met_set=True))
    _put(out, "mesh", mesh, LEAVES)
    w = partition.metric_weights(mesh)
    out["weights"] = np.asarray(w)
    out["part1"] = np.asarray(partition.sfc_partition(mesh, 4))
    part = np.asarray(partition.sfc_partition(mesh, 4, w))
    out["part"] = part
    st, comm = distribute.split_mesh(mesh, part, 4)
    _put(out, "split", st, LEAVES)
    _put(out, "comm", comm, COMM)
    _jax_io(out, mesh, st, comm)
    # new vertices: drop the global ids of every second interior vertex
    vg = np.asarray(st.vglob).copy()
    inner = np.asarray(st.vmask) & ((np.asarray(st.vtag) & tags.PARBDY) == 0)
    drop = inner & (np.arange(vg.shape[1])[None, :] % 2 == 0)
    vg[drop] = -1
    out["vglob_in"] = vg
    st = distribute.assign_global_ids(st.replace(vglob=jnp.asarray(vg)))
    out["vglob_out"] = np.asarray(st.vglob)
    comm = distribute.rebuild_comm(st)
    _put(out, "comm2", comm, COMM)
    _put(out, "merged", distribute.merge_shards(st, comm), LEAVES)
    _jax_balance(out, mesh, part)
    _jax_policy(out)


# the Medit files of the I/O checks: (name, the mesh's distribution);
# `w` holds face communicators only (vertex identity by coordinates)
IO_SOL_TYPES = [1, 2]
RAW_KEYS = ("verts", "vrefs", "tets", "trefs", "trias", "trrefs", "edges",
            "edrefs", "corners", "req_verts", "req_trias", "req_edges",
            "ridges")
CHK_KEYS = ("max_coord_err", "gid_mismatch", "count_mismatch",
            "valid_mismatch", "max_face_bc_err", "face_count_bad",
            "max_edge_mid_err", "edge_tag_mismatch")


def _io_sol(v):
    """The values of the sol-file checks: a scalar and a vector."""
    return np.concatenate([np.asarray(v)[:, :1] * 0.5 + 0.1,
                           np.asarray(v)], axis=1)


def _face_comm_only(trtag):
    """The face communicators of the coordinate-matching files: the
    shard's synthetic interface trias, one list, dummy global ids."""
    from parmmg_tpu_torch.core import tags

    ids = np.nonzero(tags.pure_interface_tria(np.asarray(trtag)))[0]
    return [(0, ids, np.arange(len(ids)))]


def _put_raw(out, key, raw):
    for k in RAW_KEYS:
        out[f"{key}/{k}"] = np.asarray(getattr(raw, k))
    for kind in ("face_comms", "node_comms"):
        for i, (c, loc, glob) in enumerate(getattr(raw, kind) or ()):
            out[f"{key}/{kind}{i}"] = np.stack(
                [np.full(len(loc), c), np.asarray(loc), np.asarray(glob)])


def _perturbed(st_vert, st_vtag, tags):
    """Coordinates with the first interface vertex of shard 1 moved by
    1e-3 in x: the communicator checks then report errors."""
    v = np.asarray(st_vert).copy()
    k = int(np.nonzero(np.asarray(st_vtag)[1] & tags.PARBDY)[0][0])
    v[1, k, 0] += 1e-3
    return v


def _diag_part(mesh):
    """Four shards cut along x + y (tet barycenters), -1 on dead slots."""
    v, t = np.asarray(mesh.vert), np.asarray(mesh.tet)
    bc = v[t].mean(axis=1)
    part = np.clip(np.floor((bc[:, 0] + bc[:, 1]) * 2), 0, 3).astype(np.int32)
    return np.where(np.asarray(mesh.tmask), part, -1)


def _bare(m):
    """A shard without its feature edges: the cube's ridges then cross
    the interfaces unseen by the per-shard detection."""
    return m.replace(edmask=m.edmask & False)


def _jax_io(out, mesh, st, comm):
    """Binary and distributed Medit I/O, the loaders, the cross-shard
    analysis, the communicator checks and renumber_sfc on the split of
    the distribute part's mesh. The files' bytes go back to the parent."""
    import os
    import tempfile

    import jax.numpy as jnp

    from parmmg_tpu.core import tags
    from parmmg_tpu.io import medit
    from parmmg_tpu.ops import analysis
    from parmmg_tpu.parallel import chkcomm, distribute, partition
    from parmmg_tpu.parallel.shard import device_mesh

    d = tempfile.mkdtemp(prefix="jio")
    vals = _io_sol(np.asarray(mesh.vert)[np.asarray(mesh.vmask)])
    medit.save_mesh(mesh, os.path.join(d, "c.mesh"))
    medit.save_mesh(mesh, os.path.join(d, "c.meshb"))
    medit.save_sol(os.path.join(d, "s.sol"), vals, IO_SOL_TYPES)
    medit.save_sol(os.path.join(d, "s.solb"), vals, IO_SOL_TYPES)
    medit.save_mesh_distributed(st, comm, os.path.join(d, "a.mesh"),
                                with_met=True)
    medit.save_mesh_distributed(st, comm, os.path.join(d, "b.meshb"),
                                with_met=True)
    for s, m in enumerate(distribute.unstack_mesh(st)):
        medit.save_mesh(m, os.path.join(d, f"w.{s}.mesh"),
                        face_comms=_face_comm_only(m.trtag))
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[f"io/file/{name}"] = np.frombuffer(f.read(), np.uint8)
    _put_raw(out, "io/raw", medit.read_mesh(os.path.join(d, "b.1.meshb")))
    for key, name, sol in (("la", "a.mesh", "a.sol"),
                           ("lb", "b.meshb", "b.solb")):
        lst, lcomm = medit.load_mesh_distributed(
            os.path.join(d, name), 4, metpath=os.path.join(d, sol),
            dtype=jnp.float64)
        _put(out, f"io/{key}", lst, LEAVES)
        _put(out, f"io/{key}c", lcomm, COMM)
    lw, lwc = distribute.stack_loaded_shards(
        [medit.read_mesh(os.path.join(d, f"w.{s}.mesh")) for s in range(4)],
        dtype=jnp.float64)
    _put(out, "io/lw", lw, LEAVES)
    _put(out, "io/lwc", lwc, COMM)
    # the cross-shard analysis on the loaded shards analysed without
    # their stored feature edges (`_bare`)
    shards = [analysis.analyze(_bare(m), ang=45.0)
              for m in distribute.unstack_mesh(lst)]
    for s, m in enumerate(analysis.cross_shard_features(shards, ang=45.0)):
        _put(out, f"io/xf{s}", m, LEAVES)
    for s, m in enumerate(analysis.cross_shard_singul(
            shards, float(np.cos(np.radians(45.0))))):
        _put(out, f"io/xs{s}", m, LEAVES)
    # a diagonal cut, which splits ridge edges between shards
    dst, _ = distribute.split_mesh(mesh, _diag_part(mesh), 4)
    shards = [analysis.analyze(_bare(m), ang=45.0)
              for m in distribute.unstack_mesh(dst)]
    for s, m in enumerate(analysis.cross_shard_features(shards, ang=45.0)):
        _put(out, f"io/xd{s}", m, LEAVES)
    dm = device_mesh(4)
    bad = lst.replace(vert=jnp.asarray(_perturbed(lst.vert, lst.vtag, tags)))
    for key, m in (("ok", lst), ("bad", bad)):
        rep = chkcomm.check_node_comm(m, lcomm, dm)
        rep.update(chkcomm.check_face_edge_comm(m, lcomm, dm))
        out[f"io/chk_{key}"] = np.asarray([rep[k] for k in CHK_KEYS],
                                          np.float64)
    _put(out, "io/rn", partition.renumber_sfc(mesh), LEAVES)


def _islands(color, tmask):
    """Colors with islands: every 37th live tet takes the next color."""
    c = np.asarray(color).copy()
    flat, live = c.reshape(-1), np.asarray(tmask).reshape(-1)
    pick = np.nonzero(live)[0][::37]
    flat[pick] = (flat[pick] + 1) % c.shape[0]
    return c


def _grown_caps(st):
    """Twice every capacity of a stacked mesh (room for the migration)."""
    return dict(pcap=st.vert.shape[1] * 2, tcap=st.tet.shape[1] * 2,
                fcap=st.tria.shape[1] * 2, ecap=st.edge.shape[1] * 2)


def _jax_balance(out, mesh, part):
    """The balancing modules on the split of the distribute part's mesh
    (global ids assigned, node tables rebuilt, shard adjacency built, as
    the driver's balancing block starts)."""
    import jax
    import jax.numpy as jnp

    from parmmg_tpu.core.mesh import compact
    from parmmg_tpu.failsafe import CapacityError
    from parmmg_tpu.models.distributed import _rebalance_full, grow_stacked
    from parmmg_tpu.parallel import distribute, migrate, partition

    st, _ = distribute.split_mesh(mesh, part, 4)
    st = distribute.assign_global_ids(st)
    comm = distribute.rebuild_comm(st)
    _put(out, "bal/in", st, LEAVES)
    disp = migrate.displace_colors(st, comm, 4, round_id=0, layers=2)
    out["bal/displace"] = np.asarray(disp)
    graph = partition.stacked_graph_colors(st, 4)
    out["bal/graph"] = np.asarray(graph)
    color = migrate.fix_contiguity(st, disp, 4)
    out["bal/fixed"] = np.asarray(color)
    noisy = _islands(graph, st.tmask)
    out["bal/fixed_noisy"] = np.asarray(
        migrate.fix_contiguity(st, jnp.asarray(noisy), 4))
    cnts = migrate.migration_counts(st, color, 4)
    out["bal/counts"] = np.asarray(cnts)
    out["bal/migrating"] = np.asarray(migrate.migrating_vertices(st, color))
    chg = (np.random.default_rng(3).random(st.vmask.shape) < 0.3) \
        & np.asarray(st.vmask)
    keys = migrate.frontier_gid_keys(st, jnp.asarray(chg))
    out["bal/chg"], out["bal/keys"] = chg, np.asarray(keys)
    # without headroom: the outcome (a mesh or the overflow) is compared
    try:
        _put(out, "bal/tight", migrate.migrate(
            st, graph, 4, int(np.asarray(
                migrate.migration_counts(st, graph, 4)).max()) + 8), LEAVES)
    except CapacityError as e:
        out["bal/tight_overflow"] = np.asarray(e.overflow)
    st2 = grow_stacked(st, **_grown_caps(st))
    color = jnp.pad(color, ((0, 0), (0, st2.tet.shape[1] - color.shape[1])),
                    constant_values=-1)
    try:
        migrate.migrate(st2, color, 4, 1)
    except CapacityError as e:
        out["bal/cap_counts"], out["bal/cap_caps"] = e.counts, e.caps
    moved = migrate.migrate(st2, color, 4, int(np.asarray(cnts).max()) + 8)
    _put(out, "bal/moved", moved, LEAVES)
    st3, comm3 = migrate.retag_interfaces(jax.vmap(compact)(moved))
    _put(out, "bal/retag", st3, LEAVES)
    _put(out, "bal/comm3", comm3, COMM)
    out["bal/decoded"] = np.asarray(migrate.frontier_from_gid_keys(st3, keys))
    st4, comm4 = _rebalance_full(st3, comm3, 4)
    _put(out, "bal/full", st4, LEAVES)
    _put(out, "bal/comm4", comm4, COMM)


def _policy_matrix(policy_cls, work_fn):
    """The decisions of tests/test_m24_balance.py's BalancePolicy matrix
    (:142-211) and its measured-work cases, one string a decision."""
    def rows(it, work, active=None):
        return dict(iter=it, shard_ne=list(work),
                    shard_active=list(active) if active is not None
                    else [1.0] * len(work))

    skew = [400, 100, 100, 100]
    runs = [
        (1.5, {}, [[rows(it, [100] * 4)] for it in range(5)]),
        (1.5, {}, [[], [dict(iter=1, failure="boom", shard_ne=[1, 2])]]),
        (2.0, {}, [[rows(0, [170, 100, 100, 100])],
                   [rows(1, [180, 100, 100, 100])]]),
        (1.5, dict(min_interval=2), [[rows(it, skew)] for it in range(3)]),
        (1.5, dict(min_interval=1), [[rows(0, skew)], [rows(1, [100] * 4)],
                                     [rows(2, skew)]]),
    ]
    table = []
    for band, kw, hists in runs:
        p = policy_cls(band, **kw)
        for it, hist in enumerate(hists):
            d = p.evaluate(hist, it)
            table.append(f"{d['action']} {d['imbalance']} {d['reason']} "
                         f"{d['work']}")
    for hist, it in (([dict(iter=3, shard_ne=[1000, 100],
                            shard_active=[0.0, 0.5])], 3),
                     ([dict(iter=3, shard_ne=[1000, 100],
                            shard_active=[0.0, 0.0])], 3),
                     ([rows(4, [10, 20]), rows(4, [30, 40])], 4),
                     ([rows(4, [10, 20])], 5)):
        table.append(str(work_fn(hist, it)))
    return np.asarray(table)


def _jax_policy(out):
    from parmmg_tpu.parallel import migrate

    out["policy"] = _policy_matrix(migrate.BalancePolicy,
                                   migrate.measured_shard_work)


def _shard_fields(vert, vmask):
    """The linear `(1, 3)` field at every live slot of stacked shards
    (0 on dead slots)."""
    v = np.asarray(vert)
    return np.where(np.asarray(vmask)[..., None],
                    _linear_fields(v.reshape(-1, 3)).reshape(
                        v.shape[:-1] + (4,)), 0.0)


def _jax_loaded_input(out):
    """The distribute part's split written as binary per-rank files with
    their metrics and loaded back, carrying the linear field as the
    other graded cases do (so the balanced run's compiled programs
    serve it): the input of the `input` case."""
    import os
    import tempfile

    import jax.numpy as jnp

    from parmmg_tpu.io import medit
    from parmmg_tpu.ops import analysis
    from parmmg_tpu.parallel import distribute, partition
    from parmmg_tpu.utils import gen

    mesh = gen.unit_cube_mesh(5, dtype=jnp.float64)
    mesh = analysis.analyze(mesh.replace(
        met=jnp.asarray(_graded(np.asarray(mesh.vert))), met_set=True))
    part = np.asarray(partition.sfc_partition(
        mesh, 4, partition.metric_weights(mesh)))
    st, comm = distribute.split_mesh(mesh, part, 4)
    path = os.path.join(tempfile.mkdtemp(prefix="jin"), "in.meshb")
    medit.save_mesh_distributed(st, comm, path, with_met=True)
    st, comm = medit.load_mesh_distributed(
        path, 4, metpath=medit.met_filename(path), dtype=jnp.float64)
    st = st.replace(fields=jnp.asarray(_shard_fields(st.vert, st.vmask)),
                    field_ncomp=(1, 3))
    _put(out, "loaded", st, LEAVES)
    return st, comm


def _jax_adapt(out, case):
    import jax.numpy as jnp

    from parmmg_tpu.models.distributed import (DistOptions,
                                               adapt_distributed,
                                               adapt_stacked_input,
                                               merge_adapted)
    from parmmg_tpu.utils import gen

    kw = _case_options(case)
    if case == "input":
        st, comm, info = adapt_stacked_input(*_jax_loaded_input(out),
                                             DistOptions(**kw))
    else:
        mesh = gen.unit_cube_mesh(5, dtype=jnp.float64)
        if case != "hsiz":
            v = np.asarray(mesh.vert)
            mesh = mesh.replace(met=jnp.asarray(_graded(v)), met_set=True,
                                fields=jnp.asarray(_linear_fields(v)),
                                field_ncomp=(1, 3))
        st, comm, info = adapt_distributed(mesh, DistOptions(**kw))
    for k in HIST_KEYS:
        out[f"hist/{k}"] = np.asarray([r[k] for r in info["history"]])
    out["status"] = np.asarray(int(info["status"]))
    for key in ("qual_in", "qual_out"):
        _put(out, key, info[key], HISTO_INT + ("qmin", "qavg"))
    _put(out, "len", info["len_out"], ("counts", "n_unit", "nedge"))
    _put(out, "stacked", st, LEAVES)
    merged = merge_adapted(st, comm)
    _put(out, "merged", merged, LEAVES)
    if case == "balanced":
        from parmmg_tpu.api import ParMesh

        pm = ParMesh(nparts=4)
        pm.stacked, pm.comm, pm.mesh = st, comm, merged
        _api_getters(out, pm)


def _api_getters(out: dict, pm) -> None:
    """The distributed getters of a ParMesh holding a stacked result
    (host numpy in both packages): per shard, the vertex and triangle
    global numbers and the node-communicator owners."""
    own = pm.get_node_communicator_owners()
    for s, (vg, tg, (rank, gid, nuni, ntot)) in enumerate(zip(
            pm.get_vertex_glonum(), pm.get_triangle_glonum(), own)):
        out[f"api/vglo{s}"], out[f"api/tglo{s}"] = vg, tg
        out[f"api/own{s}"] = np.stack([rank, gid])
        out[f"api/own_n{s}"] = np.asarray([nuni, ntot])
    out["api/nshard"] = np.asarray(len(own))


def jax_dist(*parts) -> dict:
    out = {}
    for part in parts:
        got = {}
        if part == "distribute":
            _jax_distribute(got)
        elif part == "api":
            from test_torch_adapt import jax_api

            got = jax_api()
        else:
            _jax_adapt(got, part)
        out.update({f"{part}:{k}": v for k, v in got.items()})
    return out


# the JAX side's child processes, one a group, run side by side: the
# input run, whose shards have the balanced run's shapes, follows the
# balanced one in its process (the compiled programs are reused); the
# I/O checks run with the distribute part; the library API's flows
# (tests/test_torch_adapt.py `jax_api`, ~60 s of f32 compiles) with the
# graded case, whose child ends well before the balanced one's
GROUPS = (("hsiz",), ("graded", "api"), ("balanced", "input"),
          ("distribute",))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """ref(part): one part of the JAX side, computed in the child process
    of its group (`GROUPS`). `ref.start(*parts)` starts the children of
    `parts` ahead of their use (so the port's runs overlap them);
    `ref(part)` starts its child if that has not been done and waits for
    it. Only the parts a worker's tests ask for run there."""
    waits, got = {}, {}

    def start(*parts):
        for group in GROUPS:
            if set(group) & set(parts) and group not in waits:
                waits[group] = start_jax_side(
                    __file__, "jax_dist",
                    tmp_path_factory.mktemp("jdist"), group, xla_flags=O0)

    def get(part):
        start(part)
        group = next(g for g in GROUPS if part in g)
        if part not in got:
            full = waits[group]()
            for p in group:
                n = len(p) + 1
                got[p] = {k[n:]: v for k, v in full.items()
                          if k.startswith(p + ":")}
        return got[part]

    get.start = start
    return get


# tet leaves whose slot order the reference's own jit leaves open (see
# `_assert_leaves`)
_TET_ROWS = ("tet", "tref")


def _tet_rows(tet, tref, tmask):
    """The live (tet, tref) rows of one mesh, sorted: the tets as a set."""
    rows = np.concatenate([tet, tref[:, None]], axis=1)[tmask]
    return rows[np.lexsort(rows.T[::-1])]


def _assert_leaves(got: Mesh, ref: dict, key: str, rtol=0.0,
                   tet_order=True):
    """Every leaf equal (floats within `rtol` when given). With
    `tet_order=False` the live tets (with their refs) compare as a set
    per shard: under jit, the reference's `swap_23` places its new tets
    in other slots than its own op-by-op run does on the same input, and
    the port follows the op-by-op run (ROADMAP queue 3)."""
    b = got.to_numpy_state()
    for k in LEAVES:
        a = ref[f"{key}/{k}"]
        assert b[k].shape == a.shape, (k, b[k].shape, a.shape)
        if k in _TET_ROWS and not tet_order:
            continue
        if a.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(b[k], a, rtol=rtol, atol=rtol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a, err_msg=k)
    if not tet_order:
        tm = ref[f"{key}/tmask"]
        shards = range(tm.shape[0]) if tm.ndim == 2 else [None]
        for s in shards:
            pick = (lambda x: x) if s is None else (lambda x: x[s])
            np.testing.assert_array_equal(
                _tet_rows(pick(b["tet"]), pick(b["tref"]), pick(tm)),
                _tet_rows(pick(ref[f"{key}/tet"]), pick(ref[f"{key}/tref"]),
                          pick(tm)), err_msg=("tets", s))


def _assert_comm(comm, ref: dict, key: str):
    for k in COMM:
        np.testing.assert_array_equal(getattr(comm, k).numpy(),
                                      ref[f"{key}/{k}"], err_msg=k)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _case_mesh(case: str) -> Mesh:
    """The port's input mesh of a centralized case: the unit cube n=5,
    with the graded size and the linear field but in the `hsiz` case."""
    mesh = t_gen.unit_cube_mesh(5, dtype=torch.float64, device="cpu")
    if case == "hsiz":
        return mesh
    return mesh.replace(met=_graded(mesh.vert), met_set=True,
                        fields=torch.as_tensor(
                            _linear_fields(mesh.vert.numpy())),
                        field_ncomp=(1, 3))


# the two-rank run: each rank a fresh interpreter under the env contract
# (gloo on 127.0.0.1), killed past its wall limit
RANKS = 2
RANK_WALL_S = 120
_RANK_CHILD = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import test_torch_distributed
test_torch_distributed.rank_child(sys.argv[3])
"""


def _failing_sweeps(fail_it: int):
    """Patches of `models.distributed` under which rank 1's first sweep
    of its first owned shard in iteration `fail_it` raises the error a
    card out of memory raises. Returns [(name, patched)]."""
    from parmmg_tpu_torch.parallel import multihost

    phase, body = t_dist.remesh_phase, t_dist._sweep_body
    armed = [False]

    def remesh_phase(shards, opts, emult, history, it, *a, **k):
        armed[0] = it == fail_it and multihost.rank() == 1
        return phase(shards, opts, emult, history, it, *a, **k)

    def sweep_body(*a, **k):
        if armed[0]:
            raise torch.OutOfMemoryError("injected: out of memory")
        return body(*a, **k)

    return [("remesh_phase", remesh_phase), ("_sweep_body", sweep_body)]


def rank_child(out: str) -> None:
    """One rank of the two-rank `balanced` run (`start_ranks`), on the
    CPU at f64 on one thread: `adapt_distributed`, then the sharded
    reductions of its final state; then the same run again with rank
    1's sweep failing in the first iteration after the first that
    swept (`_failing_sweeps`). Pickled to `out` with the rank's
    gathers of the first run. Imports no JAX."""
    from parmmg_tpu_torch.parallel import multihost, shard

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    assert multihost.world_size() == RANKS

    def run():
        return t_dist.adapt_distributed(
            _case_mesh("balanced"),
            t_dist.DistOptions(**_case_options("balanced")), device="cpu")

    res = dict(run=run(), rank=multihost.rank())
    res.update(hist=shard.sharded_quality_histogram(res["run"][0]),
               len=shard.sharded_length_stats(res["run"][0]),
               gathers=dict(multihost.GATHERS))
    swept = [h for h in res["run"][2]["history"]
             if "sweep" in h and not h.get("skipped")]
    res["fail_it"] = min(h["iter"] for h in swept if h["iter"] > 0)
    saved = [(k, getattr(t_dist, k)) for k, _ in
             _failing_sweeps(res["fail_it"])]
    try:
        for k, f in _failing_sweeps(res["fail_it"]):
            setattr(t_dist, k, f)
        res["failed"] = run()
    finally:
        for k, f in saved:
            setattr(t_dist, k, f)
    torch.save(res, out)


def start_ranks(tmp):
    """Start the `RANKS` rank children of `rank_child`. Returns `wait()`:
    each child's (exit code, log, pickled result or None), the children
    killed past `RANK_WALL_S` from the start."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    here = pathlib.Path(__file__).resolve().parent
    t0 = time.monotonic()
    procs = []
    for r in range(RANKS):
        env = dict(os.environ, PMMGTPU_COORDINATOR=f"127.0.0.1:{port}",
                   PMMGTPU_NUM_PROCS=str(RANKS), PMMGTPU_PROC_ID=str(r),
                   OMP_NUM_THREADS="1")
        out, log = tmp / f"rank{r}.pt", tmp / f"rank{r}.log"
        with open(log, "w") as fh:
            procs.append((out, log, subprocess.Popen(
                [sys.executable, "-c", _RANK_CHILD, str(here),
                 str(here.parent), str(out)],
                cwd=here.parent, env=env, stdout=fh,
                stderr=subprocess.STDOUT)))

    def wait():
        got = []
        for out, log, proc in procs:
            try:
                rc = proc.wait(timeout=max(1.0, t0 + RANK_WALL_S
                                           - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            res = (torch.load(out, weights_only=False)
                   if rc == 0 and out.exists() else None)
            got.append((rc, log.read_text()[-8000:], res))
        got.append(time.monotonic() - t0)
        return got

    return wait


@pytest.fixture(scope="module")
def torch_runs(ref, tmp_path_factory):
    """The port's runs of every case (CPU, f64), while the JAX side's
    runs of the same cases go on in their child processes, with the
    distribute part's: the scheduler tends to hand the module's next
    test to the same worker, which then finds it done. The two-rank
    children of the `balanced` case run alongside (`runs["ranks"]`:
    each rank's exit code, log and result, then the wall seconds)."""
    ref.start(*CASES, "distribute")
    ranks = start_ranks(tmp_path_factory.mktemp("ranks"))
    runs = {}
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for case in CASES:
            if case == "input":
                runs[case] = _input_run(tmp_path_factory.mktemp("tin"))
                continue
            runs[case] = t_dist.adapt_distributed(
                _case_mesh(case), t_dist.DistOptions(**_case_options(case)),
                device="cpu")
        runs["api"] = torch_api()
    finally:
        torch.use_deterministic_algorithms(prev)
        runs["ranks"] = ranks()
    return runs


def test_adapt_distributed_equals_live_jax(ref, torch_runs):
    """Every case (hsiz 0.18 and graded size with -nobalance, graded size
    balanced) against the live JAX runs; the distributed workflow on
    the graded mesh's split (`_check_input`): the `input` case, balanced
    from per-rank binary files with the communicator checks, against the
    live JAX run; the balanced case run by two ranks (`_check_ranks`);
    and the library API: the centralized `ParMesh` flows
    (`check_api`) and the distributed getters on the balanced result
    (`_check_getters`)."""
    for case in CASES[:-1]:
        _check_case(ref(case), torch_runs[case], case)
    _check_getters(ref("balanced"), torch_runs["balanced"])
    check_api(ref("api"), torch_runs["api"])
    _check_input(ref("input"), *torch_runs["input"])
    _check_ranks(ref("balanced"), torch_runs["balanced"],
                 torch_runs["ranks"])


def _check_getters(r, run):
    """The port's `ParMesh` getters on the balanced result equal JAX's on
    its own result exactly, with the checks of
    tests/test_m6_api_io.py:571: every live vertex numbered, as many
    distinct ids as merged vertices; tria ids contiguous, as many as
    merged trias; each interface vertex owned by the lowest shard that
    holds it."""
    st, comm, _ = run
    pm = t_api.ParMesh(nparts=4, device="cpu")
    pm.stacked, pm.comm, pm.mesh = st, comm, t_dist.merge_adapted(st, comm)
    got = {}
    _api_getters(got, pm)
    assert sorted(got) == sorted(k for k in r if k.startswith("api/"))
    for k, v in got.items():
        assert v.dtype == r[k].dtype, k
        np.testing.assert_array_equal(v, r[k], err_msg=k)
    D = int(got["api/nshard"])
    vg = np.concatenate([got[f"api/vglo{s}"] for s in range(D)])
    assert (vg >= 0).all()
    assert len(np.unique(vg)) == len(pm.get_vertices()[0])
    tg = np.concatenate([got[f"api/tglo{s}"] for s in range(D)])
    real = tg[tg >= 0]
    assert len(real) and real.max() == len(np.unique(real)) - 1
    assert len(np.unique(real)) == len(pm.get_triangles()[0])
    holders = {}
    for s in range(D):
        nuni, ntot = got[f"api/own_n{s}"]
        assert ntot >= nuni > 0
        for g in got[f"api/own{s}"][1]:
            holders.setdefault(int(g), []).append(s)
    for s in range(D):
        rank, gid = got[f"api/own{s}"]
        assert all(rk == min(holders[int(g)]) for rk, g in zip(rank, gid))
    assert all(len(h) > 1 for h in holders.values())


def _check_ranks(r, one, ranks):
    """Both ranks of the two-rank `balanced` run (gloo, each sweeping
    two of the four shards) give the same stacked mesh, node tables and
    history as each other and as the one-process run `one`, leaf for
    leaf (the rebalancings but their wall times too), and pass
    `_check_case` against the live JAX run; each made the same gathers
    (one a sweep, one for the changed masks an iteration that swept, one
    a sharded reduction), and its sharded histogram and length stats
    equal `merge_stacked_*` on the stacked mesh. In the second run, one
    rank's sweep fails: both ranks roll back together to LOWFAILURE with
    the same mesh and node tables, and the history of the one-process
    run up to the failed iteration (`_check_failed_ranks`)."""
    from parmmg_tpu_torch.ops import quality as t_q

    *ranks, wall = ranks
    for rc, log, _ in ranks:
        assert rc == 0, log
    print(f"two-rank balanced run: {wall:.1f} s wall")
    st1, comm1, info1 = one
    s1 = st1.to_numpy_state()
    hist = info1["history"]
    swept = [h for h in hist if "sweep" in h and not h.get("skipped")]
    gathers = []
    for k, (_, _, res) in enumerate(ranks):
        assert res["rank"] == k
        st, comm, info = res["run"]
        got = st.to_numpy_state()
        for leaf in LEAVES:
            np.testing.assert_array_equal(got[leaf], s1[leaf],
                                          err_msg=(k, leaf))
        assert (st.field_ncomp, st.met_set) == (st1.field_ncomp,
                                                st1.met_set)
        for f in COMM:
            assert torch.equal(getattr(comm, f), getattr(comm1, f)), (k, f)
        assert info["history"] == hist, k
        assert int(info["status"]) == int(info1["status"])
        assert [{x: b[x] for x in b if x != "wall_s"}
                for b in info["balance"]] == [
            {x: b[x] for x in b if x != "wall_s"} for b in info1["balance"]]
        _check_case(r, res["run"], "balanced")
        shards = t_distr.unstack_mesh(st)
        want_h = t_q.merge_stacked_histograms(
            [t_q.quality_histogram(m) for m in shards])
        want_l = t_q.merge_stacked_length_stats(
            [t_q.mesh_length_stats(m, int(shards[0].tcap * 1.7) + 64)
             for m in shards])
        for got_x, want_x in ((res["hist"], want_h), (res["len"], want_l)):
            for f in dataclasses.fields(want_x):
                assert torch.equal(torch.as_tensor(getattr(got_x, f.name)),
                                   torch.as_tensor(getattr(want_x, f.name))), \
                    (k, f.name)
        gathers.append(res["gathers"])
    # one gather a sweep, one for the changed masks an iteration that
    # swept, one for each sharded reduction
    assert gathers[0]["n"] == gathers[1]["n"] == (
        len(swept) + len({h["iter"] for h in swept}) + 2)
    assert gathers[0]["bytes"] == gathers[1]["bytes"] > 0
    _check_failed_ranks(hist, [res for _, _, res in ranks])


def _check_failed_ranks(hist, res):
    """Both ranks of the run whose rank 1 failed in a sweep of iteration
    `fail_it`: LOWFAILURE on both, the same stacked mesh, node tables
    and balancing, the one-process history before that iteration, and a
    failure record naming the error on rank 1 and the peer's failure on
    rank 0."""
    from parmmg_tpu_torch.core import tags

    fail_it = res[0]["fail_it"]
    assert res[1]["fail_it"] == fail_it
    runs = [r["failed"] for r in res]
    for st, comm, info in runs:
        assert int(info["status"]) == int(tags.ReturnStatus.LOWFAILURE)
    (st0, comm0, info0), (st1, comm1, info1) = runs
    a, b = st0.to_numpy_state(), st1.to_numpy_state()
    for leaf in LEAVES:
        np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=leaf)
    for f in COMM:
        assert torch.equal(getattr(comm0, f), getattr(comm1, f)), f
    assert [{x: v[x] for x in v if x != "wall_s"} for v in info0["balance"]] \
        == [{x: v[x] for x in v if x != "wall_s"} for v in info1["balance"]]
    before = [h for h in hist if h["iter"] < fail_it]
    for info, error in ((info0, "PeerFailure"), (info1, "OutOfMemoryError")):
        h = info["history"]
        assert h[:len(before)] == before
        last = h[-1]
        assert (last["iter"], last["error"]) == (fail_it, error), last
        assert "failure" in last


def _loaded_input(tmp):
    """The port's side of `_jax_loaded_input`: the graded mesh's split
    written as binary per-rank files by the port and loaded back
    (stacked, comm), carrying the linear field."""
    from parmmg_tpu_torch.ops import analysis as t_an

    mesh = t_gen.unit_cube_mesh(5, dtype=torch.float64, device="cpu")
    mesh = t_an.analyze(mesh.replace(met=_graded(mesh.vert), met_set=True))
    part = t_part.sfc_partition(mesh, 4, t_part.metric_weights(mesh))
    st, comm = t_distr.split_mesh(mesh, part.numpy(), 4)
    path = str(tmp / "in.meshb")
    t_medit.save_mesh_distributed(st, comm, path, with_met=True)
    lst, lcomm = t_medit.load_mesh_distributed(
        path, 4, metpath=t_medit.met_filename(path), dtype=torch.float64,
        device="cpu")
    return lst.replace(fields=torch.as_tensor(_shard_fields(lst.vert,
                                                            lst.vmask)),
                       field_ncomp=(1, 3)), lcomm


def _input_run(tmp):
    """The port's `input` case: `ParMesh.parmmglib_distributed`
    (`adapt_stacked_input`) on the loaded per-rank files, the options
    set through the Param setters, with every `assert_comm_ok` report it
    makes.
    Returns (loaded stacked, (stacked, comm, info), reports)."""
    st, comm = _loaded_input(tmp)
    real_check = t_dist.chkcomm.assert_comm_ok
    checks = []

    def counted(*a, **k):
        checks.append(real_check(*a, **k))
        return checks[-1]

    P = t_api.Param
    pm = t_api.ParMesh(device="cpu")
    pm.stacked, pm.comm = st, comm
    for p, v in ((P.IPARAM_niter, 2), (P.IPARAM_nparts, 4),
                 (P.IPARAM_nobalancing, 0), (P.IPARAM_debug, 1),
                 (P.IPARAM_meshSize, 16)):
        pm.set_iparameter(p, v)
    pm.opts.max_sweeps = 6  # no Param of its own, as in the JAX tests
    assert pm.opts == t_dist.DistOptions(**_case_options("input"))
    t_dist.chkcomm.assert_comm_ok = counted
    try:
        status = pm.parmmglib_distributed()
    finally:
        t_dist.chkcomm.assert_comm_ok = real_check
    assert status == 0, pm.info
    return st, (pm.stacked, pm.comm, pm.info), checks


def _check_case(r, run, case):
    st, comm, info = run
    hist = info["history"]
    assert len(hist) == len(r["hist/sweep"]) >= 8
    for i, rec in enumerate(hist):
        for k in HIST_KEYS:
            np.testing.assert_array_equal(np.asarray(rec[k]),
                                          r[f"hist/{k}"][i],
                                          err_msg=(i, k))
    for k in ("nsplit", "ncollapse", "nswap", "nmoved"):
        assert sum(rec[k] for rec in hist) > 0, k
    assert int(info["status"]) == int(r["status"]) == 0
    for key in ("qual_in", "qual_out"):
        h = info[key]
        for k in HISTO_INT:
            np.testing.assert_array_equal(np.asarray(getattr(h, k)),
                                          r[f"{key}/{k}"], err_msg=k)
        for k in ("qmin", "qavg"):
            np.testing.assert_allclose(float(getattr(h, k)),
                                       float(r[f"{key}/{k}"]), rtol=RTOL,
                                       atol=0, err_msg=k)
    for k in ("counts", "n_unit", "nedge"):
        np.testing.assert_array_equal(np.asarray(getattr(info["len_out"],
                                                         k)),
                                      r[f"len/{k}"], err_msg=k)
    _assert_leaves(st, r, "stacked", rtol=RTOL, tet_order=False)
    merged = t_dist.merge_adapted(st, comm)
    _assert_leaves(merged, r, "merged", rtol=RTOL, tet_order=False)
    assert conformity.check_mesh(merged).ok
    if case != "hsiz":
        # interpolation moved values: the graded sizes are not constant
        met = merged.met[merged.vmask, 0]
        assert float(met.max() - met.min()) > 0.1
    if case != "hsiz":
        # the field (compared with JAX's above, stacked and merged, with
        # the leaves) follows the vertices: the P1 pulls and the split
        # midpoints are exact for a linear field, so most vertices carry
        # its exact value; the surface path's nearest tria can lie off
        # the vertex, on both sides (ROADMAP queue 3)
        assert merged.field_ncomp == st.field_ncomp == (1, 3)
        live = merged.vmask.numpy()
        err = np.abs(merged.fields.numpy()[live] - _linear_fields(
            merged.vert.numpy()[live])).max(axis=1)
        assert (err < 1e-12).mean() > 0.8, (err < 1e-12).mean()
    bal = info["balance"]
    if case not in ("balanced", "input"):
        assert bal == []
        return
    # iteration 0 displaced the interfaces and moved cells, the last
    # iteration took the graph cut
    assert [(b["it"], b["trigger"]) for b in bal] == [
        (0, "displacement"), (1, "graph")]
    assert all(b["cells"] > 0 for b in bal)


def test_partition_split_and_merge_match_jax(ref, tmp_path):
    """sfc_partition with unit and metric weights, split_mesh (every
    leaf, the comm tables), assign_global_ids, rebuild_comm and
    merge_shards: exact; on that split the Medit I/O, the loaders, the
    cross-shard analysis, the communicator checks and renumber_sfc
    (`_check_io`); and the partition's prefix sum against XLA's."""
    r = ref("distribute")
    mesh = _mesh(r, "mesh")
    w = t_part.metric_weights(mesh)
    np.testing.assert_array_equal(w.numpy(), r["weights"])
    np.testing.assert_array_equal(t_part.sfc_partition(mesh, 4).numpy(),
                                  r["part1"])
    part = t_part.sfc_partition(mesh, 4, w).numpy()
    np.testing.assert_array_equal(part, r["part"])
    assert len(np.unique(part[part >= 0])) == 4
    st, comm = t_distr.split_mesh(mesh, part, 4)
    _assert_leaves(st, r, "split")
    _assert_comm(comm, r, "comm")
    assert int(comm.counts.sum()) > 0
    _check_io(r, mesh, st, comm, tmp_path)
    st = t_distr.assign_global_ids(st.replace(
        vglob=torch.as_tensor(r["vglob_in"])))
    np.testing.assert_array_equal(st.vglob.numpy(), r["vglob_out"])
    comm = t_distr.rebuild_comm(st)
    _assert_comm(comm, r, "comm2")
    merged = t_distr.merge_shards(st, comm)
    _assert_leaves(merged, r, "merged")
    assert conformity.check_mesh(merged).ok
    _check_prefix_sum(r)
    _check_balance(r)
    np.testing.assert_array_equal(
        _policy_matrix(t_mig.BalancePolicy, t_mig.measured_shard_work),
        r["policy"])


def _check_io(r, mesh, st, comm, tmp):
    """The port's Medit files of the split (centralized and per-rank,
    ASCII and binary, sols) equal JAX's byte for byte; the port's
    readers on JAX's files give JAX's RawMesh, stacked state and node
    tables (by stored global ids and by coordinate matching); on the
    analysed loaded shards `cross_shard_features` and
    `cross_shard_singul` give JAX's shards, the communicator checks
    JAX's reports (coherent tables, and perturbed coordinates); and
    `renumber_sfc` JAX's mesh."""
    from parmmg_tpu_torch.core import tags
    from parmmg_tpu_torch.ops import analysis as t_an
    from parmmg_tpu_torch.parallel import chkcomm

    jdir, pdir = tmp / "jax", tmp / "port"
    jdir.mkdir()
    pdir.mkdir()
    files = {k[len("io/file/"):]: v.tobytes() for k, v in r.items()
             if k.startswith("io/file/")}
    for name, data in files.items():
        (jdir / name).write_bytes(data)
    vals = _io_sol(mesh.vert.numpy()[mesh.vmask.numpy()])
    t_medit.save_mesh(mesh, str(pdir / "c.mesh"))
    t_medit.save_mesh(mesh, str(pdir / "c.meshb"))
    t_medit.save_sol(str(pdir / "s.sol"), vals, IO_SOL_TYPES)
    t_medit.save_sol(str(pdir / "s.solb"), vals, IO_SOL_TYPES)
    t_medit.save_mesh_distributed(st, comm, str(pdir / "a.mesh"),
                                  with_met=True)
    t_medit.save_mesh_distributed(st, comm, str(pdir / "b.meshb"),
                                  with_met=True)
    for s, m in enumerate(t_distr.unstack_mesh(st)):
        t_medit.save_mesh(m, str(pdir / f"w.{s}.mesh"),
                          face_comms=_face_comm_only(m.trtag.numpy()))
    assert sorted(p.name for p in pdir.iterdir()) == sorted(files)
    assert len(files) == 4 + 4 * 4 + 4
    for name, data in files.items():
        assert (pdir / name).read_bytes() == data, name
    assert t_medit.is_binary_file(str(jdir / "b.0.meshb"))
    assert not t_medit.is_binary_file(str(jdir / "a.0.mesh"))
    # the sol readers, both encodings
    for name, rtol in (("s.sol", 1e-14), ("s.solb", 0.0)):
        # ASCII keeps 15 significant digits, binary every bit
        got, types = t_medit.read_sol(str(jdir / name))
        assert types == IO_SOL_TYPES
        np.testing.assert_allclose(got, vals, rtol=rtol, atol=0)

    raw = t_medit.read_mesh(str(jdir / "b.1.meshb"))
    for k in RAW_KEYS:
        np.testing.assert_array_equal(getattr(raw, k), r[f"io/raw/{k}"],
                                      err_msg=k)
    for kind in ("face_comms", "node_comms"):
        comms = getattr(raw, kind)
        assert comms and len(comms) == sum(
            k.startswith(f"io/raw/{kind}") for k in r)
        for i, (c, loc, glob) in enumerate(comms):
            np.testing.assert_array_equal(
                np.stack([np.full(len(loc), c), loc, glob]),
                r[f"io/raw/{kind}{i}"], err_msg=(kind, i))
    loaded = {}
    for key, name, sol in (("la", "a.mesh", "a.sol"),
                           ("lb", "b.meshb", "b.solb")):
        loaded[key] = t_medit.load_mesh_distributed(
            str(jdir / name), 4, metpath=str(jdir / sol),
            dtype=torch.float64, device="cpu")
        _assert_leaves(loaded[key][0], r, f"io/{key}")
        _assert_comm(loaded[key][1], r, f"io/{key}c")
    lw, lwc = t_distr.stack_loaded_shards(
        [t_medit.read_mesh(str(jdir / f"w.{s}.mesh")) for s in range(4)],
        dtype=torch.float64, device="cpu")
    _assert_leaves(lw, r, "io/lw")
    _assert_comm(lwc, r, "io/lwc")
    assert int(lwc.counts.sum()) > 0

    lst, lcomm = loaded["lb"]
    shards = [t_an.analyze(_bare(m), ang=45.0)
              for m in t_distr.unstack_mesh(lst)]
    feats = t_an.cross_shard_features(shards, ang=45.0)
    singul = t_an.cross_shard_singul(shards, float(np.cos(np.radians(45.0))))
    for s in range(4):
        _assert_leaves(feats[s], r, f"io/xf{s}", rtol=RTOL)
        _assert_leaves(singul[s], r, f"io/xs{s}", rtol=RTOL)
    # the cube's ridges cross the interfaces: the agreement clears the
    # corners each side guessed where a ridge leaves its shard
    assert any(bool((a.vtag != b.vtag).any())
               for a, b in zip(singul, shards))
    # a diagonal cut splits ridge edges between shards: the pass adds them
    dst, _ = t_distr.split_mesh(mesh, _diag_part(mesh), 4)
    shards = [t_an.analyze(_bare(m), ang=45.0)
              for m in t_distr.unstack_mesh(dst)]
    feats = t_an.cross_shard_features(shards, ang=45.0)
    for s in range(4):
        _assert_leaves(feats[s], r, f"io/xd{s}", rtol=RTOL)
    assert sum(int(f.nedge) - int(m.nedge) for f, m in zip(feats, shards)) \
        > 0
    bad = lst.replace(vert=torch.as_tensor(_perturbed(lst.vert, lst.vtag,
                                                      tags)))
    for key, m in (("ok", lst), ("bad", bad)):
        rep = chkcomm.check_node_comm(m, lcomm)
        rep.update(chkcomm.check_face_edge_comm(m, lcomm))
        got = np.asarray([rep[k] for k in CHK_KEYS], np.float64)
        np.testing.assert_allclose(got, r[f"io/chk_{key}"], rtol=RTOL,
                                   atol=0, err_msg=key)
    assert chkcomm.assert_comm_ok(lst, lcomm)["count_mismatch"] == 0
    with pytest.raises(AssertionError, match="communicator check"):
        chkcomm.assert_comm_ok(bad, lcomm)
    _check_halo(lst, lcomm)
    _assert_leaves(t_part.renumber_sfc(mesh), r, "io/rn")


def _check_halo(st, comm):
    """The stacked halo combines against their definition: every copy of
    an interface vertex ends with the sum / min / max / OR over the
    copies on all shards (grouped by global id); other slots keep their
    values."""
    from parmmg_tpu_torch.parallel import comm as t_comm

    rng = np.random.default_rng(7)
    vals = torch.as_tensor(rng.integers(0, 64, st.vmask.shape),
                           dtype=torch.int32)
    g = comm.l2g.numpy()
    ci = comm.comm_idx.numpy()
    shared = np.zeros(g.shape, bool)
    for s in range(ci.shape[0]):
        for r_ in range(ci.shape[1]):
            sl = ci[s, r_][ci[s, r_] >= 0]
            shared[s, sl] = True
    v = vals.numpy()
    for fn, red in ((t_comm.halo_sum, np.add), (t_comm.halo_min, np.minimum),
                    (t_comm.halo_max, np.maximum),
                    (t_comm.halo_or, np.bitwise_or)):
        want = v.copy()
        for gid in np.unique(g[shared]):
            sel = shared & (g == gid)
            want[sel] = red.reduce(v[sel])
        np.testing.assert_array_equal(fn(vals, comm.comm_idx).numpy(), want,
                                      err_msg=fn.__name__)
    b = torch.as_tensor(v % 5 == 0)
    got = t_comm.halo_or(b, comm.comm_idx).numpy()
    want = b.numpy().copy()
    for gid in np.unique(g[shared]):
        sel = shared & (g == gid)
        want[sel] = want[sel].any()
    np.testing.assert_array_equal(got, want)


def _check_input(r, loaded, run, checks):
    """The `input` case against the live JAX run (as `_check_case`), its
    loaded shards equal JAX's, the communicator checks run once an
    iteration on coherent tables."""
    _check_case(r, run, "input")
    _assert_leaves(loaded, r, "loaded")
    assert len(checks) == CASE["niter"]
    assert all(c["face_count_bad"] == c["gid_mismatch"] == 0
               and c["max_coord_err"] == 0.0 for c in checks), checks


def _check_prefix_sum(r):
    """The partition's float32 prefix sum equals `jnp.cumsum` under jit
    bit for bit on random weights, at lengths around the tile of 16 and
    its powers (a sequential sum differs from both)."""
    seq_differs = False
    for n in CUMSUM_LENGTHS:
        x = r[f"cs{n}/in"]
        got = t_part.prefix_sum(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, r[f"cs{n}/out"], err_msg=n)
        seq_differs |= bool((np.cumsum(x, dtype=np.float32) != got).any())
    assert seq_differs


def _check_balance(r):
    """The balancing modules on the JAX side's stacked state: colors,
    contiguity repair, counts, migration, compaction, retagging and the
    node tables, the capacity errors, the frontier's gid keys and the
    full re-cut, all equal."""
    st = _mesh(r, "bal/in")
    comm = t_distr.rebuild_comm(st)
    disp = t_mig.displace_colors(st, comm, 4, round_id=0, layers=2)
    np.testing.assert_array_equal(disp.numpy(), r["bal/displace"])
    graph = t_part.stacked_graph_colors(st, 4)
    np.testing.assert_array_equal(graph.numpy(), r["bal/graph"])
    # both colorings move cells; the islands are reattached
    assert (disp.numpy() != np.arange(4)[:, None])[st.tmask.numpy()].any()
    color = t_mig.fix_contiguity(st, disp, 4)
    np.testing.assert_array_equal(color.numpy(), r["bal/fixed"])
    noisy = _islands(graph.numpy(), st.tmask.numpy())
    fixed = t_mig.fix_contiguity(st, torch.as_tensor(noisy), 4).numpy()
    np.testing.assert_array_equal(fixed, r["bal/fixed_noisy"])
    assert (fixed != noisy).any()
    cnts = t_mig.migration_counts(st, color, 4)
    np.testing.assert_array_equal(cnts.numpy(), r["bal/counts"])
    assert int(cnts.sum()) > 0
    np.testing.assert_array_equal(
        t_mig.migrating_vertices(st, color).numpy(), r["bal/migrating"])
    keys = t_mig.frontier_gid_keys(st, torch.as_tensor(r["bal/chg"]))
    np.testing.assert_array_equal(keys.numpy(), r["bal/keys"])
    tight = t_mig.migration_counts(st, graph, 4)
    if "bal/tight_overflow" in r:
        with pytest.raises(t_adapt.CapacityError) as e:
            t_mig.migrate(st, graph, 4, int(tight.max()) + 8)
        np.testing.assert_array_equal(e.value.overflow,
                                      r["bal/tight_overflow"])
    else:
        _assert_leaves(t_mig.migrate(st, graph, 4, int(tight.max()) + 8),
                       r, "bal/tight")
    st2, color = t_dist._grow(st, color, **_grown_caps(st))
    with pytest.raises(t_adapt.CapacityError) as e:
        t_mig.migrate(st2, color, 4, 1)
    np.testing.assert_array_equal(e.value.counts, r["bal/cap_counts"])
    np.testing.assert_array_equal(e.value.caps, r["bal/cap_caps"])
    moved = t_mig.migrate(st2, color, 4, int(cnts.max()) + 8)
    _assert_leaves(moved, r, "bal/moved")
    st3, comm3 = t_mig.retag_interfaces(t_distr.stack_meshes(
        [t_dist.compact(m) for m in t_distr.unstack_mesh(moved)]))
    _assert_leaves(st3, r, "bal/retag")
    _assert_comm(comm3, r, "bal/comm3")
    decoded = t_mig.frontier_from_gid_keys(st3, keys)
    np.testing.assert_array_equal(decoded.numpy(), r["bal/decoded"])
    # exact: a vertex is active on its (new) owner iff its gid was encoded
    g3, vm3 = st3.vglob.numpy(), st3.vmask.numpy()
    want = np.zeros_like(vm3)
    want[vm3] = np.isin(g3[vm3], st.vglob.numpy()[r["bal/chg"]])
    np.testing.assert_array_equal(decoded.numpy(), want)
    st4, comm4 = t_dist._rebalance_full(st3, comm3, 4)
    _assert_leaves(st4, r, "bal/full")
    _assert_comm(comm4, r, "bal/comm4")


def _check_snapshot_untouched():
    """The interpolation snapshot keeps its values through a remesh
    phase and an interpolation of the shards it was taken from."""
    mesh = t_gen.unit_cube_mesh(4, dtype=torch.float64, device="cpu")
    opts = t_dist.DistOptions(nparts=2, nobalancing=True, hsiz=0.2,
                              max_sweeps=3, niter=1)
    mesh = t_adj.build_adjacency(mesh).replace(
        met=torch.full((mesh.pcap, 1), 0.2, dtype=torch.float64),
        met_set=True)
    part = t_part.sfc_partition(mesh, 2).numpy()
    st, _ = t_distr.split_mesh(mesh, part, 2, build_shard_adjacency=False)
    shards = t_distr.unstack_mesh(st)
    # the snapshot shares its tensors with the shards, as in the driver
    old = [t_adj.build_adjacency(m) for m in shards]
    before = [o.clone() for o in old]
    hist = []
    new, _ = t_dist.remesh_phase(shards, opts, [1.6], hist, 0, 0.01)
    assert sum(h["nsplit"] for h in hist) > 0
    t_dist.interp_phase([t_dist.compact(m) for m in new], old, opts)
    for o, b in zip(old, before):
        for k in LEAVES:
            assert torch.equal(getattr(o, k), getattr(b, k)), k


def _check_cli_round_trip(tmp_path):
    """`-nparts 4 -nobalance`, then `-nparts 4 -balance 1.2 -nlayers 2
    -field f.sol`, through the CLI on the CPU: the merged mesh each
    writes is conforming and equals the API's merged mesh on the same
    options, and the fields file is the API's byte for byte."""
    raw = t_gen.unit_cube(4)
    src = str(tmp_path / "cube4.mesh")
    t_medit.save_mesh(Mesh.from_numpy(
        raw["verts"], raw["tets"], trias=raw["trias"], trrefs=raw["trrefs"],
        device="cpu"), src)
    out = str(tmp_path / "o.mesh")
    assert t_cli.main([src, "-hsiz", "0.3", "-niter", "1", "-v", "0",
                       "-nparts", "4", "-nobalance", "-mesh-size", "16",
                       "-out", out], device="cpu") == 0
    got = t_medit.load_mesh(out, t_medit.met_filename(out), device="cpu")
    assert conformity.check_mesh(got).ok
    opts = t_dist.DistOptions(hsiz=0.3, niter=1, nparts=4,
                              nobalancing=True, min_shard_elts=16)
    st, comm, _ = t_dist.adapt_distributed(
        t_medit.load_mesh(src, device="cpu"), opts, device="cpu")
    a, b = got.to_numpy(), t_dist.merge_adapted(st, comm).to_numpy()
    for k in ("tets", "trias", "trrefs", "edges"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["verts"], b["verts"])
    assert len(a["tets"]) != 6 * 4 ** 3
    # balanced: the CLI's defaults (-groups-ratio 2.0) and the flags
    # given, with a field (-field): its file is the API's merged fields
    bal = ["-nparts", "4", "-balance", "1.2", "-nlayers", "2"]
    fsol = str(tmp_path / "f.sol")
    t_medit.save_sol(fsol, _linear_fields(raw["verts"]), [1, 2])
    assert t_cli.main([src, "-hsiz", "0.3", "-niter", "2", "-v", "0",
                       "-mesh-size", "16", "-out", out, "-field", fsol]
                      + bal, device="cpu") == 0
    got = t_medit.load_mesh(out, device="cpu")
    assert conformity.check_mesh(got).ok
    mesh = t_medit.load_mesh(src, device="cpu")
    vals, ncomp = t_medit.load_fields(fsol)
    mesh = mesh.replace(fields=torch.as_tensor(np.pad(
        vals, ((0, mesh.pcap - len(vals)), (0, 0))), dtype=mesh.dtype),
        field_ncomp=ncomp)
    st, comm, info = t_dist.adapt_distributed(
        mesh, dataclasses.replace(opts, niter=2, nobalancing=False,
                                  balance_band=1.2, ifc_layers=2,
                                  grps_ratio=2.0), device="cpu")
    assert info["balance"] and info["balance"][-1]["trigger"] == "graph"
    merged = t_dist.merge_adapted(st, comm)
    a, b = got.to_numpy(), merged.to_numpy()
    for k in ("tets", "trias", "trrefs", "edges"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["verts"], b["verts"])
    t_medit.save_fields(merged, str(tmp_path / "api.sol"))
    assert (tmp_path / "o.fields.sol").read_bytes() \
        == (tmp_path / "api.sol").read_bytes()


def _check_rollback_classes(monkeypatch):
    """A failure inside an iteration of the classes the JAX driver
    absorbs (here a ValueError from the interpolation) rolls back to the
    last good shards with LOWFAILURE; a kernel's launch failure
    (`KernelError`) raises through."""
    opts = t_dist.DistOptions(hsiz=0.3, niter=2, nparts=2, nobalancing=True,
                              min_shard_elts=16, max_sweeps=3)

    def run():
        return t_dist.adapt_distributed(
            t_gen.unit_cube_mesh(3, dtype=torch.float64, device="cpu"),
            opts, device="cpu")

    good = run()
    for exc, absorbed in ((ValueError("bad value"), True),
                          (t_kernels.KernelError("launch failed"), False)):
        with monkeypatch.context() as mp:
            def fail(*a, **k):
                raise exc

            mp.setattr(t_interp.kernels, "interp_bary", fail)
            if not absorbed:
                with pytest.raises(t_kernels.KernelError):
                    run()
                continue
            st, comm, info = run()
        fails = [r for r in info["history"] if "failure" in r]
        assert int(info["status"]) == 1
        assert [(r["iter"], r["error"]) for r in fails] == [(0, "ValueError")]
        # the rollback keeps the shards the iteration started from: the
        # split mesh, before any remesh
        assert int(st.tmask.sum()) == 6 * 3 ** 3
        assert int(good[0].tmask.sum()) != 6 * 3 ** 3


def _check_refusals(tmp_path, monkeypatch):
    """What the port still leaves out stays refused, naming its ROADMAP
    item: a balance band derived from a PERF_DB, and resume (a
    checkpoint directory); a band given or in the environment is taken.
    The communicator checks (`check_comm`), refused before item 12, run
    once an iteration and raise on incoherent tables."""
    mesh = t_gen.unit_cube_mesh(3, dtype=torch.float64, device="cpu")
    opts = t_dist.DistOptions(nparts=2, niter=2, max_sweeps=2, hsiz=0.3,
                              min_shard_elts=16, check_comm=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        t_dist.adapt_distributed(mesh, dataclasses.replace(
            opts, checkpoint_dir=str(tmp_path / "ck")), device="cpu")
    reps = []
    real = t_dist.chkcomm.assert_comm_ok
    with monkeypatch.context() as mp:
        mp.setattr(t_dist.chkcomm, "assert_comm_ok",
                   lambda *a, **k: reps.append(real(*a, **k)))
        _, _, info = t_dist.adapt_distributed(mesh, opts, device="cpu")
    assert int(info["status"]) == 0 and len(reps) == 2
    with monkeypatch.context() as mp:
        # coordinates that disagree across shards fail the check, which
        # no rollback absorbs
        real_interp = t_dist.interp_phase

        def shifted(*a, **k):
            out = real_interp(*a, **k)
            return [m.replace(vert=m.vert + 1e-3 * s)
                    for s, m in enumerate(out)]

        mp.setattr(t_dist, "interp_phase", shifted)
        with pytest.raises(AssertionError, match="communicator check"):
            t_dist.adapt_distributed(mesh, opts, device="cpu")
    db = tmp_path / "perf_db.jsonl"
    db.write_text("")
    opts = t_dist.DistOptions(nparts=2)
    monkeypatch.delenv("PMMGTPU_BALANCE_BAND", raising=False)
    assert t_mig.resolve_balance_band(opts) == 1.5
    monkeypatch.setenv("PMMGTPU_PERF_DB", str(db))
    with pytest.raises(NotImplementedError, match="item 15"):
        t_mig.resolve_balance_band(opts)
    assert t_mig.resolve_balance_band(
        dataclasses.replace(opts, balance_band=2.25)) == 2.25
    monkeypatch.setenv("PMMGTPU_BALANCE_BAND", "0")
    assert t_mig.resolve_balance_band(opts) is None


# the malformed env contracts of tests/test_m10_multihost.py:19-50, in
# that order: (PMMGTPU_NUM_PROCS, PMMGTPU_PROC_ID), None = unset
_BAD_ENVS = (("2", "2"), ("2", "-1"), ("zebra", "-1"), ("0", "0"),
             ("0", None))


def _env_errors(mh, monkeypatch):
    """The `MultihostConfigError` message `mh.init_from_env()` raises on
    each of `_BAD_ENVS`."""
    msgs = []
    with monkeypatch.context() as mp:
        mp.setattr(mh, "_INITIALIZED", False)
        mp.setenv("PMMGTPU_COORDINATOR", "127.0.0.1:1")
        for world, rank in _BAD_ENVS:
            mp.setenv("PMMGTPU_NUM_PROCS", world)
            if rank is None:
                mp.delenv("PMMGTPU_PROC_ID")
            else:
                mp.setenv("PMMGTPU_PROC_ID", rank)
            with pytest.raises(mh.MultihostConfigError) as e:
                mh.init_from_env()
            msgs.append(str(e.value))
        assert not mh._INITIALIZED
    return msgs


def _stacked_fixture():
    """tests/test_m24_balance.py's `_stacked_fixture`: the unit cube n=3,
    analysed, iso size 0.25, split in 2 shards with global ids and each
    shard's adjacency."""
    from parmmg_tpu_torch.ops import analysis as t_an

    mesh = t_an.analyze(t_adj.build_adjacency(
        t_gen.unit_cube_mesh(3, dtype=torch.float64, device="cpu")))
    opts = t_dist.DistOptions(hsiz=0.25, hgrad=None, niter=1, verbose=0)
    mesh = t_adapt.prepare_metric(mesh, opts, int(mesh.tcap * 1.6) + 64)
    part = t_part.sfc_partition(mesh, 2).numpy()
    st, _ = t_distr.split_mesh(mesh, part, 2)
    st = t_distr.assign_global_ids(st)
    return [t_adj.build_adjacency(m) for m in t_distr.unstack_mesh(st)]


def _check_multihost(tmp_path, monkeypatch):
    """The multi-process layer in one process: `init_from_env` raises the
    JAX package's messages on every malformed env contract, before any
    rendezvous (the port names no `jax.distributed.initialize`);
    `owned_shards` deals contiguous ascending blocks; `barrier`,
    `agree_flags` and `gather_stacked` are identities; the sharded
    reductions equal `merge_stacked_*`; a lost peer raises through
    `adapt_distributed` instead of rolling back; a peer's failure, put
    to the world's votes, rolls this rank back with the vote that
    carried it as the iteration's last (`_check_votes`); and the kernel
    build survives two processes starting on a cold build directory."""
    from parmmg_tpu.parallel import multihost as j_mh
    from parmmg_tpu_torch.ops import quality as t_q
    from parmmg_tpu_torch.parallel import multihost as t_mh
    from parmmg_tpu_torch.parallel import shard as t_shard

    want = [m.replace("jax.distributed.initialize", "the rendezvous")
            for m in _env_errors(j_mh, monkeypatch)]
    assert _env_errors(t_mh, monkeypatch) == want
    assert [w.split(" must")[0].split(" out of")[0] for w in want] == [
        "PMMGTPU_PROC_ID=2", "PMMGTPU_PROC_ID=-1",
        "PMMGTPU_NUM_PROCS='zebra' / PMMGTPU_PROC_ID='-1'",
        "PMMGTPU_NUM_PROCS=0", "multi-host env contract incomplete: "
        "PMMGTPU_COORDINATOR='127.0.0.1:1' requires PMMGTPU_NUM_PROCS "
        "(world size) and PMMGTPU_PROC_ID (0-based rank) to be set as "
        "well"]

    for d in (4, 5):
        for world in (1, 2, 3):
            blocks = [t_shard.owned_shards(d, r, world)
                      for r in range(world)]
            assert sum(blocks, ()) == tuple(range(d)), (d, world)
            sizes = [len(b) for b in blocks]
            assert sizes == sorted(sizes, reverse=True) \
                and sizes[0] - sizes[-1] <= 1, (d, world)
    assert t_shard.owned_shards(5) == tuple(range(5))
    assert t_shard.owned_shards(2, 2, 3) == ()

    assert not t_mh.is_multiprocess() and t_mh.world_size() == 1
    t_mh.barrier()
    assert t_mh.agree_flags(6) == 6
    rows = [(torch.arange(3), torch.ones(2, dtype=torch.bool))
            for _ in range(2)]
    got = t_mh.gather_stacked(rows, 2)
    assert all(a is b for g, r in zip(got, rows) for a, b in zip(g, r))

    shards = _stacked_fixture()
    ecap = int(shards[0].tcap * 1.7) + 64
    for got, want in (
            (t_shard.sharded_quality_histogram(shards),
             t_q.merge_stacked_histograms(
                 [t_q.quality_histogram(m) for m in shards])),
            (t_shard.sharded_length_stats(t_distr.stack_meshes(shards)),
             t_q.merge_stacked_length_stats(
                 [t_q.mesh_length_stats(m, ecap) for m in shards]))):
        for f in dataclasses.fields(want):
            assert torch.equal(torch.as_tensor(getattr(got, f.name)),
                               torch.as_tensor(getattr(want, f.name))), f.name

    def lost(*a, **k):
        raise t_mh.PeerLostError("collective 'sweep' failed (rank 0)")

    with monkeypatch.context() as mp:
        mp.setattr(t_mh, "gather_stacked", lost)
        with pytest.raises(t_mh.PeerLostError):
            _small_run()
    _check_votes(t_mh, monkeypatch)
    _check_build_race(tmp_path)


def _small_run():
    return t_dist.adapt_distributed(
        t_gen.unit_cube_mesh(3, dtype=torch.float64, device="cpu"),
        t_dist.DistOptions(hsiz=0.3, niter=2, nparts=2, min_shard_elts=16,
                           max_sweeps=2), device="cpu")


def _check_votes(t_mh, monkeypatch):
    """A world of one rank that believes it has peers, whose first vote
    carries a peer's failure: at a sweep's vote (the peer's own sweep
    failed) this rank raises `PeerFailure` there and votes once more at
    the iteration's end; where the peer's vote was its iteration's last
    (it failed outside the sweeps) this rank ends the iteration on that
    vote. Either way the run rolls back to LOWFAILURE at iteration 0."""
    from parmmg_tpu_torch.core import tags

    for peer, want in ((t_dist._FAILED, ["sweep-vote", "iteration-vote"]),
                       (t_dist._FAILED | t_dist._ENDED, ["sweep-vote"])):
        votes = []

        def agree(value, tag="agree"):
            votes.append(tag)
            return value | (peer if len(votes) == 1 else 0)

        with monkeypatch.context() as mp:
            mp.setattr(t_mh, "is_multiprocess", lambda: True)
            mp.setattr(t_mh, "agree_flags", agree)
            st, _, info = _small_run()
        assert votes == want, (peer, votes)
        assert int(info["status"]) == int(tags.ReturnStatus.LOWFAILURE)
        last = info["history"][-1]
        assert (last["iter"], last["error"]) == (0, "PeerFailure"), last


# a stand-in for nvcc: books the call, then writes its output in two
# steps with a pause between them (a reader in the pause sees a torn file)
_NVCC_STUB = """#!{python}
import os, sys, time
args = sys.argv[1:]
with open(os.environ["NVCC_CALLS"], "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
with open(args[args.index("-o") + 1], "w") as f:
    f.write("half")
    f.flush()
    time.sleep(0.3)
    f.write("-whole")
"""
# a process of the race: `build_all()` into the given directory with the
# stub as nvcc and a loader that refuses a torn library, once the start
# file exists
_RACER = """
import os, sys, time
sys.path.insert(0, sys.argv[4])
from parmmg_tpu_torch.kernels import build
build.BUILD_DIR, start = sys.argv[1], sys.argv[3]
build.nvcc_path = lambda: sys.argv[2]

def load(path):
    text = open(path).read()
    assert text == "half-whole", f"torn library: {text!r}"
    return text

build.ctypes.CDLL = load
while not os.path.exists(start):
    time.sleep(0.01)
build.build_all()
print("loaded", build._LIB)
"""


def _check_build_race(tmp_path):
    """Two processes start `build_all()` together on a cold build
    directory (nvcc and the loader stubbed): the library is compiled and
    linked once, both load it whole, and no temporary file is left."""
    import os
    import pathlib
    import subprocess
    import sys

    from parmmg_tpu_torch.kernels import build

    d = tmp_path / "race"
    d.mkdir()
    stub = d / "nvcc"
    stub.write_text(_NVCC_STUB.format(python=sys.executable))
    stub.chmod(0o755)
    calls, start = d / "calls", d / "start"
    bdir = d / "_build"
    root = str(pathlib.Path(__file__).resolve().parents[1])
    env = dict(os.environ, NVCC_CALLS=str(calls))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACER, str(bdir), str(stub), str(start),
         root], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for _ in range(2)]
    start.touch()
    for p in procs:
        out = p.communicate(timeout=60)[0]
        assert p.returncode == 0 and "loaded half-whole" in out, out
    n_obj = len(build.SOURCES + build.PROBES)
    assert sorted(calls.read_text().split()) == \
        ["compile"] * n_obj + ["link"]
    names = sorted(f.name for f in bdir.iterdir())
    lib = [n for n in names if n.endswith(".so")]
    assert len(lib) == 1 and names == sorted(
        [".lock", lib[0], lib[0][:-3] + ".log.json"]), names


def test_snapshot_and_cli(tmp_path, monkeypatch):
    """The interpolation snapshot survives a remesh phase unchanged,
    `-nparts 4` runs through the CLI with and without balancing, and the
    rollback absorbs the failures the JAX driver absorbs but no kernel
    failure; what the slice leaves out is refused; the multi-process
    layer holds in one process (see the checks above)."""
    _check_snapshot_untouched()
    _check_cli_round_trip(tmp_path)
    _check_rollback_classes(monkeypatch)
    _check_refusals(tmp_path, monkeypatch)
    _check_multihost(tmp_path, monkeypatch)
