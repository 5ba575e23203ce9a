"""Modules of the PyTorch port held against the JAX package on the same
numpy inputs, on the CPU, at f64 unless stated otherwise.

The JAX side of every comparison runs in a child process (`jax_side`):
it builds the inputs, runs the JAX functions and hands inputs and
outputs back as numpy arrays. So the XLA programs it compiles never load
into the test process, which the rest of the suite shares. The port then
runs here on the same inputs.

Integer leaves (connectivity, masks, tags, tables, counts) must be equal.
Floats agree within `_rtol` of tests/test_m18_kernels.py (5e-11 at f64)
relative to the value, with the unit cube's coordinate scale (1) as the
floor for values that cancel to ~0: the reference rounds under XLA's
multiply-add contraction, the port rounds every operation.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from parmmg_tpu_torch.core import adjacency as t_adj
from parmmg_tpu_torch.core import mesh as t_mesh
from parmmg_tpu_torch.core import metric as t_met
from parmmg_tpu_torch.io import medit as t_medit
from parmmg_tpu_torch.ops import analysis as t_an
from parmmg_tpu_torch.ops import collapse as t_col
from parmmg_tpu_torch.ops import quality as t_q
from parmmg_tpu_torch.ops import smooth as t_sm
from parmmg_tpu_torch.ops import split as t_sp
from parmmg_tpu_torch.ops import swap as t_sw
from parmmg_tpu_torch.utils import conformity as t_conf
from parmmg_tpu_torch.utils import gen as t_gen

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 5e-11

# the child process: tests/conftest.py's JAX set-up (CPU platform, x64),
# then one function of a test module, whose dict of arrays goes to .npz
_CHILD = """
import os, runpy, sys
import numpy as np
sys.path.insert(0, os.path.dirname(sys.argv[2]))
runpy.run_path(sys.argv[1])
ns = runpy.run_path(sys.argv[2])
np.savez(sys.argv[3], **ns[sys.argv[4]](*sys.argv[5:]))
"""


def start_jax_side(test_file, fn_name: str, out_dir, *calls,
                   xla_flags: str = ""):
    """Start `fn_name(*args)` of the module `test_file` for each tuple
    `args` in `calls`, each in a child process of its own that imports
    JAX as tests/conftest.py sets it up (with `xla_flags` added to
    XLA_FLAGS). Returns `wait()`, which waits for them all and returns
    the union of the dicts of numpy arrays they build."""
    out_dir = pathlib.Path(out_dir)
    env = dict(os.environ)
    if xla_flags:
        env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {xla_flags}".strip()
    procs = []
    for i, args in enumerate(calls):
        out, log = out_dir / f"{fn_name}{i}.npz", out_dir / f"{fn_name}{i}.log"
        with open(log, "w") as fh:
            procs.append((out, log, subprocess.Popen(
                [sys.executable, "-c", _CHILD,
                 str(ROOT / "tests" / "conftest.py"), str(test_file),
                 str(out), fn_name, *map(str, args)],
                cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT)))

    def wait() -> dict:
        ref = {}
        for out, log, proc in procs:
            assert proc.wait() == 0, log.read_text()[-8000:]
            with np.load(out) as z:
                ref.update({k: z[k] for k in z.files})
        return ref

    return wait


def jax_side(test_file, fn_name: str, out_dir, *calls, **kw) -> dict:
    """`start_jax_side(...)`, waited for."""
    return start_jax_side(test_file, fn_name, out_dir, *calls, **kw)()


def put_mesh(out: dict, key: str, jm) -> None:
    """Store a JAX mesh's leaves (and its static fields) under `key`."""
    for k in t_mesh.LEAVES:
        out[f"{key}/{k}"] = np.asarray(getattr(jm, k))
    out[f"{key}/field_ncomp"] = np.asarray(jm.field_ncomp, dtype=np.int64)
    out[f"{key}/met_set"] = np.asarray(bool(jm.met_set))


def mesh_state(ref: dict, key: str) -> dict:
    return {k: ref[f"{key}/{k}"] for k in t_mesh.LEAVES}


def to_torch(ref: dict, key: str):
    """The port's Mesh on the JAX mesh stored under `key`."""
    return t_mesh.Mesh.from_jax_state(
        mesh_state(ref, key), device="cpu",
        field_ncomp=tuple(int(x) for x in ref[f"{key}/field_ncomp"]),
        met_set=bool(ref[f"{key}/met_set"]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port runs on one CPU thread here: at these sizes more threads
    only add synchronisation, which turns into seconds when the cores
    are contended, and the suite's other workers need the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, cube_mesh_path):
    """jax_ref(test): the JAX side of one test's checks, its parts
    computed in child processes side by side when the test asks for it
    (so their time is the test's)."""
    cache = {}

    def get(test: str) -> dict:
        if test not in cache:
            cache[test] = jax_side(
                __file__, "jax_ops", tmp_path_factory.mktemp(test),
                *[(part, cube_mesh_path) for part in JAX_PARTS[test]])
        return cache[test]

    return get


def assert_same(ref, got, what=""):
    """Equal ints/bools; floats within RTOL (scale floor 1)."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


def assert_same_mesh(ref: dict, key: str, tm):
    got = tm.to_numpy_state()
    for k in t_mesh.LEAVES:
        assert_same(ref[f"{key}/{k}"], got[k], f"{key}/{k}")
    assert tuple(int(x) for x in ref[f"{key}/field_ncomp"]) == \
        tuple(tm.field_ncomp)
    assert bool(ref[f"{key}/met_set"]) == bool(tm.met_set)


# ---------------------------------------------------------------------------
# the JAX side (runs in the child process)
# ---------------------------------------------------------------------------


def _jax_prepared(n=4, perturb=0.0, seed=0, hsiz=0.18):
    """A JAX cube analyzed, with a constant metric, compacted."""
    import jax.numpy as jnp

    from parmmg_tpu.core import mesh as j_mesh
    from parmmg_tpu.ops import analysis as j_an
    from parmmg_tpu.utils import gen as j_gen

    jm = j_gen.unit_cube_mesh(n, dtype=jnp.float64, perturb=perturb,
                              seed=seed)
    jm = jm.with_capacity(jm.pcap * 4, jm.tcap * 4, jm.fcap * 3,
                          jm.ecap + 64)
    jm = j_an.analyze(jm)
    jm = jm.replace(met=jnp.full((jm.pcap, 1), hsiz, jm.dtype),
                    met_set=True)
    return j_mesh.compact(jm)


def _jax_bipyramid():
    """Three needle tets around the interior edge (0,0,-1)-(0,0,1): the
    3-2 swap's textbook case, as a compacted analyzed JAX mesh."""
    import jax.numpy as jnp

    from parmmg_tpu.core import adjacency as j_adj
    from parmmg_tpu.core import mesh as j_mesh
    from parmmg_tpu.ops import analysis as j_an

    ring = [(0.5 * np.cos(t), 0.5 * np.sin(t), 0.0)
            for t in (0.0, 2 * np.pi / 3, 4 * np.pi / 3)]
    verts = np.array([(0.0, 0.0, -1.0), (0.0, 0.0, 1.0)] + ring)
    tets = np.array([[0, 1, 2, 3], [0, 1, 3, 4], [0, 1, 4, 2]])
    jm = j_mesh.Mesh.from_numpy(verts, tets, dtype=jnp.float64, pcap=16,
                                tcap=16, fcap=16, ecap=16)
    jm = j_an.analyze(j_adj.build_adjacency(jm))
    return j_mesh.compact(jm.replace(met=jnp.full((16, 1), 0.5, jm.dtype),
                                     met_set=True))


def _jax_tables(out, key, jm):
    """The operators' edge table of `jm`, stored under `key`."""
    from parmmg_tpu.core import adjacency as j_adj

    ecap = int(jm.tcap * 1.6) + 64
    je = j_adj.unique_edges(jm, ecap)
    out[f"{key}/ecap"] = np.asarray(ecap)
    for a, name in zip(je, ("edges", "emask", "t2e", "n_unique")):
        out[f"{key}/{name}"] = np.asarray(a)
    return je[:3]


def _jax_data_model(out, cube_mesh_path, tmp):
    import jax.numpy as jnp

    from parmmg_tpu.core import adjacency as j_adj
    from parmmg_tpu.core import mesh as j_mesh
    from parmmg_tpu.io import medit as j_medit
    from parmmg_tpu.utils import conformity as j_conf
    from parmmg_tpu.utils import gen as j_gen

    raw = j_gen.unit_cube(3)
    for k, v in raw.items():
        out[f"raw/{k}"] = np.asarray(v)
    kw = dict(trias=raw["trias"], trrefs=raw["trrefs"], vrefs=raw["vrefs"])
    for dt, jdt in (("f32", jnp.float32), ("f64", jnp.float64)):
        put_mesh(out, f"from_numpy/{dt}", j_mesh.Mesh.from_numpy(
            raw["verts"], raw["tets"], dtype=jdt, **kw))

    # compaction: a third of the tets killed, every vertex they leave
    # unreferenced too, plus a REQUIRED vertex that must survive
    jm = j_gen.unit_cube_mesh(4, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    tmask = np.asarray(jm.tmask) & (rng.uniform(size=jm.tcap) > 0.33)
    vtag = np.asarray(jm.vtag).copy()
    vtag[5] |= 8  # tags.REQUIRED
    jm = jm.replace(tmask=jnp.asarray(tmask), vtag=jnp.asarray(vtag))
    put_mesh(out, "compact/in", jm)
    put_mesh(out, "compact/out", j_mesh.compact(jm))

    # adjacency and edge tables, dead slots included, the second ecap
    # overflowing
    for kind, mk, kwk in (("cube", j_gen.unit_cube_mesh,
                           dict(perturb=0.2, seed=4)),
                          ("ball", j_gen.unit_ball_mesh, {})):
        jm = mk(4, dtype=jnp.float64, **kwk)
        tmask = np.asarray(jm.tmask).copy()
        tmask[::7] = False
        jm = jm.replace(tmask=jnp.asarray(tmask))
        put_mesh(out, f"adj/{kind}", jm)
        adj = j_adj.build_adjacency(jm)
        out[f"adj/{kind}/adja_out"] = np.asarray(adj.adja)
        out[f"adj/{kind}/bfaces"] = np.asarray(j_adj.boundary_faces(adj))
        nu_full = int(j_adj.unique_edges(jm, 6 * jm.tcap)[3])
        out[f"adj/{kind}/nu_full"] = np.asarray(nu_full)
        for i, ecap in enumerate((6 * jm.tcap, nu_full - 37)):
            out[f"adj/{kind}/{i}/ecap"] = np.asarray(ecap)
            for a, name in zip(j_adj.unique_edges(jm, ecap),
                               ("edges", "emask", "t2e", "n_unique")):
                out[f"adj/{kind}/{i}/{name}"] = np.asarray(a)

    # Medit: the bytes the JAX writers give
    jm = j_medit.load_mesh(cube_mesh_path, dtype=jnp.float64)
    put_mesh(out, "medit", jm)
    j_medit.save_mesh(jm, f"{tmp}/j.mesh")
    j_medit.save_met(jm, f"{tmp}/j.sol")
    for ext in ("mesh", "sol"):
        with open(f"{tmp}/j.{ext}", "rb") as fh:
            out[f"medit/{ext}_bytes"] = np.frombuffer(fh.read(), np.uint8)

    # the conformity oracle on a good mesh and one with an inverted tet
    jm = j_gen.unit_cube_mesh(3, dtype=jnp.float64)
    tet = np.asarray(jm.tet).copy()
    tet[0, [0, 1]] = tet[0, [1, 0]]
    for i, m in enumerate((jm, jm.replace(tet=jnp.asarray(tet)))):
        rep = j_conf.check_mesh(m)
        put_mesh(out, f"conf/{i}", m)
        out[f"conf/{i}/ok"] = np.asarray(rep.ok)
        out[f"conf/{i}/errors"] = np.asarray(list(rep.errors), dtype=str)


def _jax_analysis(out):
    import jax.numpy as jnp

    from parmmg_tpu.ops import analysis as j_an
    from parmmg_tpu.utils import gen as j_gen

    for kind, mk in (("cube", j_gen.unit_cube_mesh),
                     ("ball", j_gen.unit_ball_mesh)):
        jm = mk(4, dtype=jnp.float64)
        jm = jm.with_capacity(fcap=jm.fcap + 8)
        put_mesh(out, f"an/{kind}/in", jm)
        ja = j_an.analyze(jm)
        put_mesh(out, f"an/{kind}/out", ja)
        out[f"an/{kind}/normals"] = np.asarray(j_an.vertex_normals(ja))
        for x, name in zip(j_an.tria_normals(ja), ("unit", "area", "ok")):
            out[f"an/{kind}/tria_{name}"] = np.asarray(x)

    jm = j_gen.unit_cube_mesh(3, dtype=jnp.float64)
    trmask = np.asarray(jm.trmask).copy()
    trmask[::3] = False
    jm = jm.replace(trmask=jnp.asarray(trmask))
    put_mesh(out, "synth/in", jm)
    put_mesh(out, "synth/out", j_an.analyze(jm, ang=30.0))


def _jax_metric_quality(out):
    import jax.numpy as jnp

    from parmmg_tpu.core import adjacency as j_adj
    from parmmg_tpu.core import metric as j_met
    from parmmg_tpu.ops import quality as j_q
    from parmmg_tpu.utils import gen as j_gen

    # metric algebra on seeded SPD tensors
    rng = np.random.default_rng(21)
    A = rng.normal(size=(64, 3, 3))
    M = A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(3)
    m6 = M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    jm = j_gen.unit_cube_mesh(3, dtype=jnp.float64, perturb=0.2, seed=9)
    e, em, _, _ = j_adj.unique_edges(jm, 6 * jm.tcap)
    h = rng.uniform(0.05, 0.5, size=(jm.pcap, 1))
    d = dict(m6=m6, bary=rng.dirichlet(np.ones(4), size=16),
             edges=np.asarray(e), emask=np.asarray(em), h=h,
             m6p=m6[rng.integers(0, 64, jm.pcap)],
             req=rng.uniform(size=jm.pcap) < 0.1)
    for k, v in d.items():
        out[f"met/in/{k}"] = v
    put_mesh(out, "met/mesh", jm)
    for name in ("log_sym6", "exp_sym6", "metric_det", "sym6_to_mat"):
        out[f"met/{name}"] = np.asarray(getattr(j_met, name)(
            jnp.asarray(m6 * 0.1)))
    mets = m6[:64].reshape(16, 4, 6)
    for C, mm in ((1, np.abs(mets[..., :1]) + 0.1), (6, mets)):
        out[f"met/interp/{C}/in"] = mm
        out[f"met/interp/{C}"] = np.asarray(j_met.interp_metric(
            jnp.asarray(mm), jnp.asarray(d["bary"])))
    out["met/hbounds"] = np.asarray(j_met.apply_hbounds(jnp.asarray(m6),
                                                        0.8, 1.5))
    p0, p1 = m6[:32, :3], m6[32:, :3]
    for C, (m0, m1) in ((1, (h[:32], h[32:64])), (6, (m6[:32], m6[32:]))):
        out[f"met/edge_length/{C}"] = np.asarray(j_met.edge_length(
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(m0),
            jnp.asarray(m1)))
    out["met/implied_iso"] = np.asarray(j_met.implied_iso_metric(
        jm.vert, jm.tet, jm.tmask, jm.pcap))
    out["met/implied_aniso"] = np.asarray(j_met.implied_aniso_metric(
        jm.vert, jm.tet, jm.tmask, jm.pcap))
    je, jem, req = jnp.asarray(d["edges"]), jnp.asarray(d["emask"]), \
        jnp.asarray(d["req"])
    out["met/gradate_iso"] = np.asarray(j_met.gradate_iso(
        jm.vert, jnp.asarray(h), je, jem, fixed=req))
    for C, m in ((1, h), (6, d["m6p"])):
        out[f"met/gradate_from_required/{C}"] = np.asarray(
            j_met.gradate_from_required(jm.vert, jnp.asarray(m), je, jem,
                                        req, hgrad=1.2))
    out["met/gradate_aniso"] = np.asarray(j_met.gradate_aniso(
        jm.vert, jnp.asarray(d["m6p"]), je, jem, niter=3))

    # quality, histograms and length statistics
    jm = _jax_prepared(4, perturb=0.2, seed=5)
    put_mesh(out, "q/in", jm)
    out["q/tet_quality"] = np.asarray(j_q.tet_quality(jm))
    jh = j_q.quality_histogram(jm)
    out["q/hist_text"] = np.asarray(j_q.format_histogram(jh))
    for k in ("ne", "worst_elt", "nbad", "ninverted", "counts", "qmin",
              "qmax", "qavg"):
        out[f"q/hist/{k}"] = np.asarray(getattr(jh, k))
    jl = j_q.mesh_length_stats(jm)
    out["q/len_text"] = np.asarray(j_q.format_length_stats(jl))
    for k, v in j_q.length_stats_doc(jl).items():
        out[f"q/len_doc/{k}"] = np.asarray(v)


def _jax_split(out):
    from parmmg_tpu.ops import split as j_sp

    for case, perturb in (("uniform", 0.0), ("perturbed", 0.2)):
        jm = _jax_prepared(4, perturb=perturb, seed=6, hsiz=0.15)
        put_mesh(out, f"split/{case}/in", jm)
        jo, js = j_sp.split_long_edges(
            jm, *_jax_tables(out, f"split/{case}", jm))
        put_mesh(out, f"split/{case}/out", jo)
        for k in ("nsplit", "ncand", "capped"):
            out[f"split/{case}/{k}"] = np.asarray(getattr(js, k))


def _jax_collapse(out):
    from parmmg_tpu.ops import collapse as j_col

    for case, perturb in (("uniform", 0.0), ("perturbed", 0.2)):
        jm = _jax_prepared(4, perturb=perturb, seed=7, hsiz=0.6)
        put_mesh(out, f"collapse/{case}/in", jm)
        jo, js = j_col.collapse_short_edges(
            jm, *_jax_tables(out, f"collapse/{case}", jm), hausd=0.02)
        put_mesh(out, f"collapse/{case}/out", jo)
        for k in COLLAPSE_STATS:
            out[f"collapse/{case}/{k}"] = np.asarray(getattr(js, k))


def _jax_swap32(out):
    from parmmg_tpu.ops import swap as j_sw

    jm = _jax_bipyramid()
    put_mesh(out, "swap32/in", jm)
    jo, js = j_sw.swap_32(jm, *_jax_tables(out, "swap32", jm))
    put_mesh(out, "swap32/out", jo)
    out["swap32/nswap32"] = np.asarray(js.nswap32)


def _jax_swap23_smoothing(out):
    from parmmg_tpu.core import adjacency as j_adj
    from parmmg_tpu.core import mesh as j_mesh
    from parmmg_tpu.ops import smooth as j_sm
    from parmmg_tpu.ops import swap as j_sw

    jm = _jax_prepared(4, perturb=0.3, seed=0, hsiz=0.25)
    put_mesh(out, "swap23/in", jm)
    je = _jax_tables(out, "swap23", jm)
    jo, js = j_sw.swap_23(j_adj.build_adjacency(jm), je[0], je[1])
    put_mesh(out, "swap23/out", jo)
    out["swap23/nswap23"] = np.asarray(js.nswap23)
    jo, js = j_sm.smooth_vertices(j_mesh.compact(jo), je[0], je[1])
    put_mesh(out, "smooth/out", jo)
    for k in ("nmoved", "nfrozen"):
        out[f"smooth/{k}"] = np.asarray(getattr(js, k))


COLLAPSE_STATS = ("ncollapse", "ncand", "nrej_geom", "nrej_topo",
                  "nrej_surf", "nsurf")


# the parts of each test's JAX side, each run in a child process
JAX_PARTS = {
    "data_model": ("data_model",),
    "analysis": ("analysis", "metric_quality"),
    "split_collapse": ("split", "collapse"),
    "swaps": ("swap32", "swap23"),
}


def jax_ops(part: str, cube_mesh_path: str) -> dict:
    """The JAX inputs and outputs of one part of a test's checks."""
    import tempfile

    out = {}
    if part == "data_model":
        with tempfile.TemporaryDirectory() as tmp:
            _jax_data_model(out, cube_mesh_path, tmp)
    else:
        {"analysis": _jax_analysis, "metric_quality": _jax_metric_quality,
         "split": _jax_split, "collapse": _jax_collapse,
         "swap32": _jax_swap32, "swap23": _jax_swap23_smoothing}[part](out)
    return out


# ---------------------------------------------------------------------------
# data model, fixtures, I/O
# ---------------------------------------------------------------------------


def _check_from_numpy_and_jax_state_round_trip(ref, dt):
    tdt = {"f32": torch.float32, "f64": torch.float64}[dt]
    raw = t_gen.unit_cube(3)
    for k, v in raw.items():
        np.testing.assert_array_equal(v, ref[f"raw/{k}"], err_msg=k)
    kw = dict(trias=raw["trias"], trrefs=raw["trrefs"], vrefs=raw["vrefs"])
    tm = t_mesh.Mesh.from_numpy(raw["verts"], raw["tets"], dtype=tdt,
                                device="cpu", **kw)
    key = f"from_numpy/{dt}"
    assert_same_mesh(ref, key, tm)
    back = to_torch(ref, key)
    for k, v in back.to_numpy_state().items():
        assert v.dtype == ref[f"{key}/{k}"].dtype, k
        np.testing.assert_array_equal(v, ref[f"{key}/{k}"])
    assert back.dtype == tdt


def _check_compact_slot_for_slot(ref):
    assert_same_mesh(ref, "compact/out",
                     t_mesh.compact(to_torch(ref, "compact/in")))


def _check_adjacency_and_unique_edges(ref, kind):
    key = f"adj/{kind}"
    tm = to_torch(ref, key)
    adj = t_adj.build_adjacency(tm)
    assert_same(ref[f"{key}/adja_out"], adj.adja, "adja")
    for i in (0, 1):
        te = t_adj.unique_edges(tm, int(ref[f"{key}/{i}/ecap"]))
        for b, name in zip(te, ("edges", "emask", "t2e", "n_unique")):
            assert_same(ref[f"{key}/{i}/{name}"], b, name)
    # the second table overflowed: it holds fewer edges than it counted
    assert int(te[3]) == int(ref[f"{key}/nu_full"]) > int(te[1].sum())
    np.testing.assert_array_equal(ref[f"{key}/bfaces"],
                                  t_adj.boundary_faces(adj).numpy())


def _check_medit_round_trip_same_bytes(ref, cube_mesh_path, tmp_path):
    tm = t_medit.load_mesh(cube_mesh_path, dtype=torch.float64,
                           device="cpu")
    assert_same_mesh(ref, "medit", tm)
    t_medit.save_mesh(tm, str(tmp_path / "t.mesh"))
    t_medit.save_met(tm, str(tmp_path / "t.sol"))
    for ext in ("mesh", "sol"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            ref[f"medit/{ext}_bytes"].tobytes(), ext
    vals, types = t_medit.read_sol(str(tmp_path / "t.sol"))
    assert types == [t_medit.SOL_SCALAR] and vals.shape == (
        int(tm.npoin), 1)


def _check_conformity_oracle_agrees(ref):
    for i in (0, 1):
        rep = t_conf.check_mesh(to_torch(ref, f"conf/{i}"))
        assert rep.ok == bool(ref[f"conf/{i}/ok"])
        assert list(rep.errors) == list(ref[f"conf/{i}/errors"])
    assert not rep.ok


# ---------------------------------------------------------------------------
# analysis, metric, quality
# ---------------------------------------------------------------------------


def _check_analyze_tags_ridges_normals(ref, kind):
    ta = t_an.analyze(to_torch(ref, f"an/{kind}/in"))
    assert_same_mesh(ref, f"an/{kind}/out", ta)
    assert int(ta.nedge) > 0 or kind == "ball"
    assert_same(ref[f"an/{kind}/normals"], t_an.vertex_normals(ta),
                "normals")
    for y, name in zip(t_an.tria_normals(ta), ("unit", "area", "ok")):
        assert_same(ref[f"an/{kind}/tria_{name}"], y, name)


def _check_analyze_synthesizes_missing_trias(ref):
    assert_same_mesh(ref, "synth/out",
                     t_an.analyze(to_torch(ref, "synth/in"), ang=30.0))


def _tt(x):
    return torch.tensor(np.asarray(x))


def _close_scaled(got, want, rtol):
    """Within rtol of the value, with rtol of the largest value as the
    floor."""
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _check_metric_algebra(ref):
    m6 = ref["met/in/m6"]
    for name in ("log_sym6", "exp_sym6", "metric_det", "sym6_to_mat"):
        _close_scaled(getattr(t_met, name)(_tt(m6 * 0.1)), ref[f"met/{name}"],
                      RTOL)
    for C in (1, 6):
        _close_scaled(t_met.interp_metric(_tt(ref[f"met/interp/{C}/in"]),
                                          _tt(ref["met/in/bary"])),
                      ref[f"met/interp/{C}"], RTOL)
    _close_scaled(t_met.apply_hbounds(_tt(m6), 0.8, 1.5), ref["met/hbounds"],
                  RTOL)
    h = ref["met/in/h"]
    p0, p1 = m6[:32, :3], m6[32:, :3]
    for C, (m0, m1) in ((1, (h[:32], h[32:64])), (6, (m6[:32], m6[32:]))):
        assert_same(ref[f"met/edge_length/{C}"],
                    t_met.edge_length(_tt(p0), _tt(p1), _tt(m0), _tt(m1)),
                    "edge_length")


def _check_metric_from_mesh_and_gradation(ref):
    tm = to_torch(ref, "met/mesh")
    assert_same(ref["met/implied_iso"],
                t_met.implied_iso_metric(tm.vert, tm.tet, tm.tmask, tm.pcap),
                "implied_iso")
    _close_scaled(t_met.implied_aniso_metric(tm.vert, tm.tet, tm.tmask,
                                             tm.pcap),
                  ref["met/implied_aniso"], 1e3 * RTOL)
    te, tem = _tt(ref["met/in/edges"]), _tt(ref["met/in/emask"])
    req, h, m6p = (_tt(ref[f"met/in/{k}"]) for k in ("req", "h", "m6p"))
    assert_same(ref["met/gradate_iso"],
                t_met.gradate_iso(tm.vert, h, te, tem, fixed=req),
                "gradate_iso")
    for C, m in ((1, h), (6, m6p)):
        assert_same(ref[f"met/gradate_from_required/{C}"],
                    t_met.gradate_from_required(tm.vert, m, te, tem, req,
                                                hgrad=1.2),
                    "gradate_from_required")
    _close_scaled(t_met.gradate_aniso(tm.vert, m6p, te, tem, niter=3),
                  ref["met/gradate_aniso"], 1e3 * RTOL)


def _check_quality_histograms_and_lengths(ref):
    tm = to_torch(ref, "q/in")
    assert_same(ref["q/tet_quality"], t_q.tet_quality(tm), "q")
    th = t_q.quality_histogram(tm)
    assert t_q.format_histogram(th) == str(ref["q/hist_text"])
    for k in ("ne", "worst_elt", "nbad", "ninverted", "counts", "qmin",
              "qmax", "qavg"):
        assert_same(ref[f"q/hist/{k}"], getattr(th, k), k)
    tl = t_q.mesh_length_stats(tm)
    assert t_q.format_length_stats(tl) == str(ref["q/len_text"])
    td = t_q.length_stats_doc(tl)
    keys = sorted(k.split("/", 2)[2] for k in ref
                  if k.startswith("q/len_doc/"))
    assert keys == sorted(td)
    for k in keys:
        assert_same(ref[f"q/len_doc/{k}"], td[k], k)


# ---------------------------------------------------------------------------
# operators: same mesh + edge table in, same accepted set + mesh out
# ---------------------------------------------------------------------------


def _tables(ref, key, tm):
    te = t_adj.unique_edges(tm, int(ref[f"{key}/ecap"]))
    for b, name in zip(te, ("edges", "emask", "t2e", "n_unique")):
        assert_same(ref[f"{key}/{name}"], b, name)
    return te[:3]


def _check_split_long_edges(ref, case):
    key = f"split/{case}"
    tm = to_torch(ref, f"{key}/in")
    to, ts = t_sp.split_long_edges(tm, *_tables(ref, key, tm))
    assert int(ref[f"{key}/nsplit"]) == int(ts.nsplit) > 0
    assert int(ref[f"{key}/ncand"]) == int(ts.ncand)
    assert bool(ref[f"{key}/capped"]) == bool(ts.capped)
    assert_same_mesh(ref, f"{key}/out", to)


def _check_collapse_short_edges(ref, case):
    key = f"collapse/{case}"
    tm = to_torch(ref, f"{key}/in")
    to, ts = t_col.collapse_short_edges(tm, *_tables(ref, key, tm),
                                        hausd=0.02)
    for k in COLLAPSE_STATS:
        assert int(ref[f"{key}/{k}"]) == int(getattr(ts, k)), k
    assert int(ts.ncollapse) > 0
    assert_same_mesh(ref, f"{key}/out", to)


def _check_swap_32(ref):
    tm = to_torch(ref, "swap32/in")
    to, ts = t_sw.swap_32(tm, *_tables(ref, "swap32", tm))
    assert int(ref["swap32/nswap32"]) == int(ts.nswap32) == 1
    assert_same_mesh(ref, "swap32/out", to)


def _check_swap_23_and_smoothing(ref):
    tm = to_torch(ref, "swap23/in")
    te = _tables(ref, "swap23", tm)
    to, ts = t_sw.swap_23(t_adj.build_adjacency(tm), te[0], te[1])
    assert int(ref["swap23/nswap23"]) == int(ts.nswap23) > 0
    assert_same_mesh(ref, "swap23/out", to)
    to, ts = t_sm.smooth_vertices(t_mesh.compact(to), te[0], te[1])
    assert int(ref["smooth/nmoved"]) == int(ts.nmoved) > 0
    assert int(ref["smooth/nfrozen"]) == int(ts.nfrozen)
    assert_same_mesh(ref, "smooth/out", to)


# ---------------------------------------------------------------------------
# the tests: each runs a group of the checks above
# ---------------------------------------------------------------------------


def test_data_model_and_io(jax_ref, cube_mesh_path, tmp_path):
    ref = jax_ref("data_model")
    for dt in ("f32", "f64"):
        _check_from_numpy_and_jax_state_round_trip(ref, dt)
    _check_compact_slot_for_slot(ref)
    for kind in ("cube", "ball"):
        _check_adjacency_and_unique_edges(ref, kind)
    _check_medit_round_trip_same_bytes(ref, cube_mesh_path, tmp_path)
    _check_conformity_oracle_agrees(ref)


def test_analysis_metric_and_quality(jax_ref):
    ref = jax_ref("analysis")
    for kind in ("cube", "ball"):
        _check_analyze_tags_ridges_normals(ref, kind)
    _check_analyze_synthesizes_missing_trias(ref)
    _check_metric_algebra(ref)
    _check_metric_from_mesh_and_gradation(ref)
    _check_quality_histograms_and_lengths(ref)


def test_split_and_collapse(jax_ref):
    ref = jax_ref("split_collapse")
    for case in ("uniform", "perturbed"):
        _check_split_long_edges(ref, case)
        _check_collapse_short_edges(ref, case)


def test_swaps_and_smoothing(jax_ref):
    ref = jax_ref("swaps")
    _check_swap_32(ref)
    _check_swap_23_and_smoothing(ref)
