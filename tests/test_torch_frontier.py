"""Frontier (active-set) sweeps of the port held against the JAX package
on the CPU, at f64.

The JAX side runs in two child processes (`test_torch_ops.start_jax_side`)
while the port works here:

- the centralized adaptation `adapt(AdaptOptions(frontier=True))` on the
  unit cube n=4 (hsiz 0.18, niter 1, 12 sweeps, no gradation; its
  closures stop covering the whole mesh from sweep 9 on): every integer
  history key, `n_active` included, the final mesh slot for slot and the
  histograms must equal the live JAX run's;
- on a jittered unit cube n=4 with a random size field:
  `one_ring_closure` and `compact_aux`; a schedule of split, 2-3 swap,
  collapse and 3-2 swap, each under a random `active` mask with no
  compaction in between, each operator's output mesh, counts and
  `changed_v` slot for slot, then smoothing likewise; the incremental
  `merge_unique_edges` and `update_adjacency` over the schedule's
  changes, bit for bit against JAX, and against the full rebuilds (the
  adjacency bit for bit, the edge table as a table: the same live
  edges, count and per-tet pairs — the merge reuses freed slots, so its
  numbering differs by design), with forced K-overflow fallbacks, which
  give the full rebuilds bit for bit;
- two frontier sweeps from the schedule's mesh (`_sweep_body`, the JAX
  package's unfused sweep): the first from a stale frontier, the second
  from the JAX side's successor frontier handed to the port through
  `Frontier.from_jax_state`; meshes, stats and successor frontiers equal;
- a sweep offered an empty frontier over clean tables is the identity
  (tests/test_m12_frontier.py:77), on the port's adapted mesh, and so is
  the distributed remesh phase with a drained carry, which records one
  zero-op `skipped` sweep (tests/test_m12_frontier.py:342).

Floats within 5e-11 (the scale floor of tests/test_torch_ops.py).
"""

import numpy as np
import torch

from parmmg_tpu_torch.core import adjacency as t_adj
from parmmg_tpu_torch.core import mesh as t_mesh
from parmmg_tpu_torch.models import adapt as t_adapt
from parmmg_tpu_torch.models import distributed as t_dist
from parmmg_tpu_torch.ops import collapse as t_col
from parmmg_tpu_torch.ops import common as t_common
from parmmg_tpu_torch.ops import smooth as t_sm
from parmmg_tpu_torch.ops import split as t_sp
from parmmg_tpu_torch.ops import swap as t_sw
from parmmg_tpu_torch.parallel import distribute as t_distr
from parmmg_tpu_torch.parallel import partition as t_part
from parmmg_tpu_torch.utils import conformity, gen as t_gen
from test_torch_ops import (  # noqa: F401
    assert_same, assert_same_mesh, one_torch_thread, put_mesh,
    start_jax_side, to_torch)

CASE = dict(hsiz=0.18, niter=1, max_sweeps=12, hgrad=None)
HIST_KEYS = t_adapt.HIST_COLS + ("in_band", "iter", "sweep")
HIST_FIELDS = ("ne", "counts", "nbad", "ninverted", "worst_elt", "qmin",
               "qavg", "qmax")
SCHEDULE = ("split", "swap23", "collapse", "swap32")
COUNT = {"split": "nsplit", "swap23": "nswap23", "collapse": "ncollapse",
         "swap32": "nswap32", "smooth": "nmoved"}
FR_KEYS = ("changed", "edges", "emask", "t2e", "n_unique", "dirty",
           "adja_ok")
STAT_KEYS = ("nsplit", "ncollapse", "nswap", "nmoved", "n_unique",
             "split_capped", "n_active", "n_len_unit", "n_len_edges")


# ---------------------------------------------------------------------------
# the JAX side (child processes)
# ---------------------------------------------------------------------------


def _put_frontier(out, key, fr):
    out[f"{key}/changed"] = np.asarray(fr.changed)
    out[f"{key}/dirty"] = np.asarray(fr.dirty)
    for a, name in zip(fr.tables, ("edges", "emask", "t2e", "n_unique")):
        out[f"{key}/{name}"] = np.asarray(a)
    out[f"{key}/adja_ok"] = np.asarray(fr.adja_ok)


def _jax_adapt(out):
    import jax.numpy as jnp

    from parmmg_tpu.models import adapt as j_adapt
    from parmmg_tpu.utils import gen as j_gen

    jm, ji = j_adapt.adapt(j_gen.unit_cube_mesh(4, dtype=jnp.float64),
                           j_adapt.AdaptOptions(frontier=True, **CASE))
    for k in HIST_KEYS:
        out[f"hist/{k}"] = np.asarray([r[k] for r in ji["history"]])
    out["status"] = np.asarray(int(ji["status"]))
    for key in ("qual_in", "qual_out"):
        for k in HIST_FIELDS:
            out[f"{key}/{k}"] = np.asarray(getattr(ji[key], k))
    out["len_counts"] = np.asarray(ji["len_out"].counts)
    put_mesh(out, "adapt/out", jm)


def _jax_ops(out):
    import jax
    import jax.numpy as jnp

    from parmmg_tpu.core import adjacency as j_adj
    from parmmg_tpu.core import mesh as j_mesh
    from parmmg_tpu.core import tags
    from parmmg_tpu.models import adapt as j_adapt
    from parmmg_tpu.ops import analysis as j_an
    from parmmg_tpu.ops import collapse as j_col
    from parmmg_tpu.ops import common as j_common
    from parmmg_tpu.ops import smooth as j_sm
    from parmmg_tpu.ops import split as j_sp
    from parmmg_tpu.ops import swap as j_sw
    from parmmg_tpu.utils import gen as j_gen

    def copy(m):
        # the operators donate their input buffers
        return jax.tree_util.tree_map(
            lambda x: jnp.copy(x) if isinstance(x, jax.Array) else x, m)

    rng = np.random.default_rng(7)
    m = j_mesh.compact(j_gen.unit_cube_mesh(4, dtype=jnp.float64))
    v = np.asarray(m.vert).copy()
    inner = np.asarray(m.vmask) & ((np.asarray(m.vtag) & tags.BDY) == 0)
    v[inner] += rng.uniform(-0.35, 0.35, v[inner].shape) / 4
    m = m.replace(vert=jnp.asarray(v),
                  met=jnp.asarray(rng.uniform(0.08, 0.6, (m.pcap, 1))),
                  met_set=True)
    m = j_adj.build_adjacency(m)
    pcap = m.pcap
    # smoothing relaxes a perturbed analysed cube under a uniform size
    m_smooth = j_an.analyze(j_gen.unit_cube_mesh(
        4, dtype=jnp.float64, perturb=0.3, seed=0))
    m_smooth = j_mesh.compact(m_smooth.replace(
        met=jnp.full((m_smooth.pcap, 1), 0.25, jnp.float64), met_set=True))

    # closure and compact_aux (a fifth of the tets killed)
    chg = rng.random(pcap) < 0.1
    out["closure/changed"] = chg
    out["closure/out"] = np.asarray(j_common.one_ring_closure(
        m.tet, m.tmask, jnp.asarray(chg)))
    tmask = np.asarray(m.tmask).copy()
    tmask[::5] = False
    aux = rng.random((pcap, 2)) < 0.5
    mk = m.replace(tmask=jnp.asarray(tmask))
    put_mesh(out, "aux/in", mk)
    out["aux/in/aux"] = aux
    mo, ao = j_mesh.compact_aux(copy(mk), jnp.asarray(aux))
    put_mesh(out, "aux/out", mo)
    out["aux/out/aux"] = np.asarray(ao)

    # the operator schedule, stable numbering throughout
    ecap = int(m.tcap * 1.9) + 64
    out["ecap"] = np.asarray(ecap)
    tab0 = j_adj.unique_edges(m, ecap)
    for a, name in zip(tab0, ("edges", "emask", "t2e", "n_unique")):
        out[f"tab0/{name}"] = np.asarray(a)
    changed = jnp.zeros(pcap, bool)
    for op in SCHEDULE + ("smooth",):
        act = rng.random(pcap) < 0.6
        if op == "swap23":
            m = j_adj.build_adjacency(m)
        if op == "smooth":
            m_sched, m = m, m_smooth
        e, em, t2, _ = j_adj.unique_edges(m, ecap)
        key = f"op/{op}"
        put_mesh(out, f"{key}/in", m)
        out[f"{key}/active"] = act
        act = jnp.asarray(act)
        if op == "split":
            m, st = j_sp.split_long_edges(m, e, em, t2, active=act)
        elif op == "swap23":
            m, st = j_sw.swap_23(m, e, em, active=act)
        elif op == "collapse":
            m, st = j_col.collapse_short_edges(m, e, em, t2, hausd=0.05,
                                               active=act)
        elif op == "swap32":
            m, st = j_sw.swap_32(m, e, em, t2, active=act)
        else:
            m, st = j_sm.smooth_vertices(m, e, em, active=act)
        put_mesh(out, f"{key}/out", m)
        out[f"{key}/count"] = np.asarray(getattr(st, COUNT[op]))
        out[f"{key}/changed_v"] = np.asarray(st.changed_v)
        if op != "smooth":
            changed = changed | st.changed_v
        if op == "swap32":
            # the incremental rebuilds over the schedule's changes
            out["merge/changed"] = np.asarray(changed)
            put_mesh(out, "merge/mesh", m)
            for K in (m.tcap, 2):
                for a, name in zip(
                        j_adj.merge_unique_edges(
                            m, changed, *tab0, K=K),
                        ("edges", "emask", "t2e", "n_unique")):
                    out[f"merge/{K}/{name}"] = np.asarray(a)
            out["merge/adja_in"] = np.asarray(m.adja)
            for K in (4 * m.tcap, 8):
                out[f"update/{K}"] = np.asarray(j_adj.update_adjacency(
                    copy(m), changed, K=K).adja)
            out["update/full"] = np.asarray(
                j_adj.build_adjacency(m).adja)
    # two unfused frontier sweeps from a stale frontier
    m = m_sched
    fr = j_adapt.empty_frontier(m, ecap)._replace(changed=changed)
    for s in ("a", "b"):
        put_mesh(out, f"sweep/{s}/in", m)
        _put_frontier(out, f"sweep/{s}/fr_in", fr)
        m, sst, fr = j_adapt._sweep_body(copy(m), ecap, fused=False,
                                         frontier=fr)
        put_mesh(out, f"sweep/{s}/out", m)
        _put_frontier(out, f"sweep/{s}/fr_out", fr)
        for k in STAT_KEYS:
            out[f"sweep/{s}/{k}"] = np.asarray(getattr(sst, k))


def jax_frontier(part: str) -> dict:
    out = {}
    (_jax_adapt if part == "adapt" else _jax_ops)(out)
    return out


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------


def _t(ref, key, dtype=None):
    return torch.as_tensor(np.asarray(ref[key]), dtype=dtype)


def _frontier(ref, key):
    return t_adapt.Frontier.from_jax_state(
        {k: ref[f"{key}/{k}"] for k in FR_KEYS}, device="cpu")


def _assert_frontier(ref, key, fr):
    assert_same(ref[f"{key}/changed"], fr.changed, f"{key}/changed")
    for a, name in zip(fr.tables, ("edges", "emask", "t2e", "n_unique")):
        assert_same(ref[f"{key}/{name}"], a.to(torch.int32)
                    if name == "n_unique" else a, f"{key}/{name}")
    assert int(ref[f"{key}/dirty"]) == fr.dirty, key
    assert bool(ref[f"{key}/adja_ok"]) == fr.adja_ok, key


def _assert_table_equiv(m, tab, full):
    """The same live edge set and count, and every live tet's row naming
    the same vertex pairs; dead tets name none."""
    (e_i, em_i, t2e_i, nu_i), (e_f, em_f, t2e_f, nu_f) = tab, full
    assert int(nu_i) == int(nu_f)
    assert {tuple(r) for r in e_i[em_i].tolist()} == \
        {tuple(r) for r in e_f[em_f].tolist()}
    live = m.tmask
    assert bool((t2e_i[live] >= 0).all())
    assert torch.equal(e_i[t2e_i[live].long()], e_f[t2e_f[live].long()])
    assert bool((t2e_i[~live] == -1).all())


def _check_closure_and_compact_aux(r):
    m = to_torch(r, "op/split/in")
    got = t_common.one_ring_closure(m.tet, m.tmask,
                                    _t(r, "closure/changed"))
    assert_same(r["closure/out"], got, "closure")
    assert bool(got.sum() > r["closure/changed"].sum())
    mo, ao = t_mesh.compact_aux(to_torch(r, "aux/in"), _t(r, "aux/in/aux"))
    assert_same_mesh(r, "aux/out", mo)
    assert_same(r["aux/out/aux"], ao, "aux")


def _check_operators(r):
    """Each operator of the schedule from the JAX side's input state:
    the same output mesh, count and changed_v."""
    ecap = int(r["ecap"])
    for op in SCHEDULE + ("smooth",):
        key = f"op/{op}"
        m = to_torch(r, f"{key}/in")
        e, em, t2, _ = t_adj.unique_edges(m, ecap)
        act = _t(r, f"{key}/active")
        if op == "split":
            out, st = t_sp.split_long_edges(m, e, em, t2, active=act)
        elif op == "swap23":
            out, st = t_sw.swap_23(m, e, em, active=act)
        elif op == "collapse":
            out, st = t_col.collapse_short_edges(m, e, em, t2, hausd=0.05,
                                                 active=act)
        elif op == "swap32":
            out, st = t_sw.swap_32(m, e, em, t2, active=act)
        else:
            out, st = t_sm.smooth_vertices(m, e, em, active=act)
        assert int(r[f"{key}/count"]) == int(getattr(st, COUNT[op])), op
        assert_same(r[f"{key}/changed_v"], st.changed_v, f"{op} changed_v")
        assert_same_mesh(r, f"{key}/out", out)
        assert int(getattr(st, COUNT[op])) > 0, op


def _check_incremental_tables(r):
    m = to_torch(r, "merge/mesh")
    changed = _t(r, "merge/changed")
    tab0 = [_t(r, f"tab0/{k}") for k in ("edges", "emask", "t2e",
                                         "n_unique")]
    full = t_adj.unique_edges(m, int(r["ecap"]))
    for K in (m.tcap, 2):
        tab = t_adj.merge_unique_edges(m, changed, *tab0, K=K)
        for a, name in zip(tab, ("edges", "emask", "t2e", "n_unique")):
            assert_same(r[f"merge/{K}/{name}"], a, f"merge K={K} {name}")
        _assert_table_equiv(m, tab, full)
        if K == 2:
            # the overflow fallback is the full re-sort
            for a, b in zip(tab, full):
                assert torch.equal(a, b.to(a.dtype))
    adja_full = t_adj.build_adjacency(m).adja
    assert_same(r["update/full"], adja_full, "build_adjacency")
    for K in (4 * m.tcap, 8):
        got = t_adj.update_adjacency(m, changed, K=K).adja
        assert_same(r[f"update/{K}"], got, f"update_adjacency K={K}")
        assert torch.equal(got, adja_full)
    assert not np.array_equal(r["merge/adja_in"], r["update/full"])


def _check_sweeps(r):
    """Two frontier sweeps; the second starts from the JAX side's
    successor frontier."""
    ecap = int(r["ecap"])
    m = to_torch(r, "sweep/a/in")
    fr = _frontier(r, "sweep/a/fr_in")
    for s in ("a", "b"):
        if s == "b":
            m, fr = to_torch(r, "sweep/b/in"), _frontier(r, "sweep/b/fr_in")
        m, st, fr = t_adapt._sweep_body(m, ecap, frontier=fr)
        assert_same_mesh(r, f"sweep/{s}/out", m)
        for k in STAT_KEYS:
            assert int(r[f"sweep/{s}/{k}"]) == int(getattr(st, k)), (s, k)
        _assert_frontier(r, f"sweep/{s}/fr_out", fr)


def _check_adapt(r, tm, ti):
    th = ti["history"]
    assert len(r["hist/sweep"]) == len(th) == CASE["max_sweeps"]
    for i, b in enumerate(th):
        for k in HIST_KEYS:
            assert r[f"hist/{k}"][i] == b[k], (b["sweep"], k,
                                               r[f"hist/{k}"][i], b[k])
    assert int(ti["status"]) == int(r["status"]) == 0
    for key in ("qual_in", "qual_out"):
        for k in HIST_FIELDS:
            assert_same(r[f"{key}/{k}"], getattr(ti[key], k), f"{key}/{k}")
    assert_same(r["len_counts"], ti["len_out"].counts, "len_counts")
    assert_same_mesh(r, "adapt/out", tm)
    assert conformity.check_mesh(tm).ok


def _check_noop_sweep_is_identity(mesh):
    """An empty frontier over clean tables: no op, the mesh unchanged,
    the successor frontier drained and clean."""
    mesh = t_adj.build_adjacency(t_mesh.compact(mesh))
    ecap = int(mesh.tcap * 1.6) + 64
    edges, emask, t2e, nu = t_adj.unique_edges(mesh, ecap)
    fr = t_adapt.Frontier(torch.zeros(mesh.pcap, dtype=torch.bool), 0,
                          (edges, emask, t2e, nu.to(torch.int32)), True)
    out, st, fr2 = t_adapt._sweep_body(mesh, ecap, phase_skip=False,
                                       frontier=fr)
    for k in ("nsplit", "ncollapse", "nswap", "nmoved", "n_active"):
        assert int(getattr(st, k)) == 0, k
    for k in t_mesh.LEAVES:
        assert torch.equal(getattr(out, k), getattr(mesh, k)), k
    assert int(fr2.changed.sum()) == 0 and fr2.dirty == 0 and fr2.adja_ok


def _check_drained_phase_is_identity():
    """A drained carry skips the distributed remesh phase: the shards
    come back untouched, with one zero-op `skipped` record and the carry
    still drained."""
    mesh = t_adj.build_adjacency(
        t_gen.unit_cube_mesh(3, dtype=torch.float64, device="cpu"))
    st, _ = t_distr.split_mesh(mesh, t_part.sfc_partition(mesh, 2).numpy(),
                               2, build_shard_adjacency=False)
    shards = t_distr.unstack_mesh(st)
    hist = [dict(n_unique=100, in_band=0.5)]
    zeros = [torch.zeros(m.pcap, dtype=torch.bool) for m in shards]
    out, fr = t_dist.remesh_phase(
        shards, t_dist.DistOptions(nparts=2, nobalancing=True, hsiz=0.2),
        [1.6], hist, 9, 0.01, fr0=zeros)
    rec = hist[-1]
    assert len(hist) == 2 and rec["skipped"] and rec["iter"] == 9
    assert rec["nsplit"] + rec["ncollapse"] + rec["nswap"] == 0
    assert rec["n_active"] == 0 and rec["n_unique"] == 100
    assert rec["ne"] == int(mesh.ntet) and rec["in_band"] == 0.5
    assert all(a is b for a, b in zip(out, shards))
    assert all(int(c.sum()) == 0 for c in fr)


def test_frontier_matches_live_jax(tmp_path):
    wait = start_jax_side(__file__, "jax_frontier", tmp_path, ("adapt",),
                          ("ops",))
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        tm, ti = t_adapt.adapt(
            t_gen.unit_cube_mesh(4, dtype=torch.float64, device="cpu"),
            t_adapt.AdaptOptions(frontier=True, **CASE), device="cpu")
        _check_noop_sweep_is_identity(tm)
        _check_drained_phase_is_identity()
        r = wait()
        _check_adapt(r, tm, ti)
        _check_closure_and_compact_aux(r)
        _check_operators(r)
        _check_incremental_tables(r)
        _check_sweeps(r)
    finally:
        torch.use_deterministic_algorithms(prev)
