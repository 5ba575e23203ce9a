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
- The slice as a whole: `adapt_distributed(DistOptions(nparts=4,
  nobalancing=True, frontier=False, niter=2, min_shard_elts=16,
  max_sweeps=6))` on the unit cube n=5, once with `hsiz=0.18` and once
  with a graded iso metric, against the live JAX run: the per-sweep
  integer history (the keys of tests/test_m1_remesh.py:258 and more,
  with `shard_ne`) and the histogram counts equal; the stacked and the
  merged mesh equal, vertices slot for slot with coordinates and metric
  within `_rtol` (5e-11), the live tets as a set (the reference's jit
  and op-by-op runs order them differently, see `_assert_leaves`);
  qmin/qavg within 5e-11 relative.
- The snapshot the interpolation reads is not touched by the remesh, and
  `-nparts 4 -nobalance` runs through the CLI.
"""

import dataclasses

import numpy as np
import pytest
import torch

from parmmg_tpu_torch import __main__ as t_cli
from parmmg_tpu_torch import kernels as t_kernels
from parmmg_tpu_torch.core import adjacency as t_adj
from parmmg_tpu_torch.core.mesh import LEAVES, Mesh
from parmmg_tpu_torch.io import medit as t_medit
from parmmg_tpu_torch.models import distributed as t_dist
from parmmg_tpu_torch.ops import interp as t_interp
from parmmg_tpu_torch.parallel import distribute as t_distr
from parmmg_tpu_torch.parallel import partition as t_part
from parmmg_tpu_torch.utils import conformity, gen as t_gen
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


def _graded(v):
    """The graded iso size of the tests: 0.1 + 0.15 x."""
    return (0.1 + 0.15 * v[:, 0])[:, None]


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


def _jax_adapt(out, case):
    import jax.numpy as jnp

    from parmmg_tpu.models.distributed import (DistOptions,
                                               adapt_distributed,
                                               merge_adapted)
    from parmmg_tpu.utils import gen

    mesh = gen.unit_cube_mesh(5, dtype=jnp.float64)
    kw = dict(CASE)
    if case == "hsiz":
        kw["hsiz"] = 0.18
    else:
        mesh = mesh.replace(met=jnp.asarray(_graded(np.asarray(mesh.vert))),
                            met_set=True)
    st, comm, info = adapt_distributed(mesh, DistOptions(**kw))
    for k in HIST_KEYS:
        out[f"hist/{k}"] = np.asarray([r[k] for r in info["history"]])
    out["status"] = np.asarray(int(info["status"]))
    for key in ("qual_in", "qual_out"):
        _put(out, key, info[key], HISTO_INT + ("qmin", "qavg"))
    _put(out, "len", info["len_out"], ("counts", "n_unit", "nedge"))
    _put(out, "stacked", st, LEAVES)
    _put(out, "merged", merge_adapted(st, comm), LEAVES)


def jax_dist(*parts) -> dict:
    out = {}
    for part in parts:
        got = {}
        if part == "distribute":
            _jax_distribute(got)
        else:
            _jax_adapt(got, part)
        out.update({f"{part}:{k}": v for k, v in got.items()})
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """ref(part): one part of the JAX side. The children start when the
    fixture is set up (two processes, so the port's runs overlap them)
    and are waited for when a test first asks for a part."""
    wait = start_jax_side(__file__, "jax_dist",
                          tmp_path_factory.mktemp("jdist"),
                          ("hsiz", "distribute"), ("graded",), xla_flags=O0)
    full = {}

    def get(part):
        if not full:
            full.update(wait())
        n = len(part) + 1
        return {k[n:]: v for k, v in full.items()
                if k.startswith(part + ":")}

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


@pytest.fixture(scope="module")
def torch_runs():
    """The port's runs of both cases (CPU, f64)."""
    runs = {}
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for case in ("hsiz", "graded"):
            mesh = t_gen.unit_cube_mesh(5, dtype=torch.float64,
                                        device="cpu")
            kw = dict(CASE)
            if case == "hsiz":
                kw["hsiz"] = 0.18
            else:
                mesh = mesh.replace(met=_graded(mesh.vert), met_set=True)
            runs[case] = t_dist.adapt_distributed(
                mesh, t_dist.DistOptions(**kw), device="cpu")
    finally:
        torch.use_deterministic_algorithms(prev)
    return runs


def test_adapt_distributed_equals_live_jax(ref, torch_runs):
    """Both cases (hsiz 0.18, graded size) against the live JAX runs."""
    for case in ("hsiz", "graded"):
        _check_case(ref(case), torch_runs[case], case)


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
    if case == "graded":
        # interpolation moved values: the graded sizes are not constant
        met = merged.met[merged.vmask, 0]
        assert float(met.max() - met.min()) > 0.1


def test_partition_split_and_merge_match_jax(ref):
    """sfc_partition with unit and metric weights, split_mesh (every
    leaf, the comm tables), assign_global_ids, rebuild_comm and
    merge_shards: exact; and the partition's prefix sum against XLA's."""
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
    st = t_distr.assign_global_ids(st.replace(
        vglob=torch.as_tensor(r["vglob_in"])))
    np.testing.assert_array_equal(st.vglob.numpy(), r["vglob_out"])
    comm = t_distr.rebuild_comm(st)
    _assert_comm(comm, r, "comm2")
    merged = t_distr.merge_shards(st, comm)
    _assert_leaves(merged, r, "merged")
    assert conformity.check_mesh(merged).ok
    _check_prefix_sum(r)


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
    new = t_dist.remesh_phase(shards, opts, [1.6], hist, 0, 0.01)
    assert sum(h["nsplit"] for h in hist) > 0
    t_dist.interp_phase([t_dist.compact(m) for m in new], old, opts)
    for o, b in zip(old, before):
        for k in LEAVES:
            assert torch.equal(getattr(o, k), getattr(b, k)), k


def _check_cli_round_trip(tmp_path):
    """`-nparts 4 -nobalance` through the CLI on the CPU: the merged
    mesh it writes is conforming and equals the API's merged mesh."""
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
    with pytest.raises(NotImplementedError, match="item 10"):
        t_dist.adapt_distributed(t_medit.load_mesh(src, device="cpu"),
                                 dataclasses.replace(opts,
                                                     nobalancing=False),
                                 device="cpu")


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


def test_snapshot_and_cli(tmp_path, monkeypatch):
    """The interpolation snapshot survives a remesh phase unchanged,
    `-nparts 4 -nobalance` runs through the CLI, and the rollback
    absorbs the failures the JAX driver absorbs but no kernel failure
    (see the checks above)."""
    _check_snapshot_untouched()
    _check_cli_round_trip(tmp_path)
    _check_rollback_classes(monkeypatch)
