"""The slice of the port as a whole: `parmmg_tpu_torch.models.adapt.adapt`
and the CLI held against live runs of the JAX package on the CPU, plus the
rules of the port (no JAX in it, no silent CPU fallback, unported options
refused).

The adaptation case is tests/test_m1_remesh.py:244 with full-table sweeps
(unit cube n=4, hsiz 0.18, niter 1, max_sweeps 6, no gradation; the
frontier sweeps are held in tests/test_torch_frontier.py) at f64:
the per-sweep integer history, final counts and histogram counts must be
equal, qmin and qavg within 5e-11 relative (the sums run in another
order), the final mesh equal slot for slot (coordinates within 5e-11). The JAX
run is made in a child process (`test_torch_ops.jax_side`).

Solution fields, level set and VTK (a second child, compiled at XLA's
backend optimisation level 0 as in tests/test_torch_interp.py):
`discretize_levelset` gives the JAX package's arrays bit for bit on the
sphere and plane cases of tests/test_m7_levelset.py and on a sphere
through vertices of the grid (snapped); `adapt()` of the discretized
sphere carrying a `(1, 3)` linear field (frontier sweeps, hsiz 0.2,
niter 1, max_sweeps 6) gives JAX's per-sweep integer history and final
mesh slot for slot (the live tets as a set, see `_assert_mesh_leaves`),
coordinates, metric, ls and fields within 5e-11;
`save_fields`, `save_vtu` and `save_pvtu` write JAX's bytes for that
adapted mesh, and `load_vtu` reads JAX's file into JAX's arrays. The
CLI's `-field`, `-ls` and `.vtu` paths write what the API gives.

The library API: the `ParMesh` flows of tests/test_m6_api_io.py:19
(manual setters on the cube n=3, metric 0.25, hgrad 1.3, niter 1) and
:50 (cube n=2, a corner, a required vertex, metric 0.6) through both
packages' `api` on the same calls (`api_flow`, `api_record`; held in
tests/test_torch_distributed.py, whose `graded` child runs JAX's side at
XLA's optimisation level 0). The C ABI shim (`native/parmmg_capi.c` of
the port), built here with gcc and loaded with ctypes, gives the port's
`ParMesh` results bit for bit, and the native tokenizer the Python
one's tokens (`test_rules_of_the_port`).
"""

import ast
import ctypes
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from parmmg_tpu_torch import __main__ as t_cli
from parmmg_tpu_torch import api as t_api
from parmmg_tpu_torch.core import mesh as t_mesh
from parmmg_tpu_torch.core import tags
from parmmg_tpu_torch.io import medit as t_medit
from parmmg_tpu_torch.io import vtk as t_vtk
from parmmg_tpu_torch.models import adapt as t_adapt
from parmmg_tpu_torch.models import levelset as t_ls
from parmmg_tpu_torch.parallel import distribute as t_distr
from parmmg_tpu_torch.parallel.distribute import stack_meshes
from parmmg_tpu_torch.utils import conformity, gen as t_gen
from test_torch_ops import (one_torch_thread, put_mesh,  # noqa: F401
                            start_jax_side, to_torch)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 5e-11
CASE = dict(hsiz=0.18, niter=1, max_sweeps=6, hgrad=None)

HIST_KEYS = t_adapt.HIST_COLS + ("in_band", "iter", "sweep")
HIST_FIELDS = ("ne", "counts", "nbad", "ninverted", "worst_elt", "qmin",
               "qavg", "qmax")


def jax_adapt() -> dict:
    """The case through the JAX package's `adapt` (in the child
    process): per-sweep history, status, counts, histograms and the
    final mesh's leaves."""
    import jax.numpy as jnp

    from parmmg_tpu.models import adapt as j_adapt
    from parmmg_tpu.utils import gen as j_gen

    jm, ji = j_adapt.adapt(j_gen.unit_cube_mesh(4, dtype=jnp.float64),
                           j_adapt.AdaptOptions(frontier=False, **CASE))
    out = {f"hist/{k}": np.asarray([r[k] for r in ji["history"]])
           for k in HIST_KEYS}
    out.update(status=np.asarray(int(ji["status"])),
               ntet=np.asarray(int(jm.ntet)), npoin=np.asarray(int(jm.npoin)),
               len_counts=np.asarray(ji["len_out"].counts),
               len_n_unit=np.asarray(int(ji["len_out"].n_unit)))
    for key in ("qual_in", "qual_out"):
        for k in HIST_FIELDS:
            out[f"{key}/{k}"] = np.asarray(getattr(ji[key], k))
    for k in t_mesh.LEAVES:
        out[f"mesh/{k}"] = np.asarray(getattr(jm, k))
    return out


O0 = "--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false"
LS_CASE = dict(hsiz=0.2, niter=1, max_sweeps=6, hgrad=None)
# level-set cases on the unit cube n=4: (isovalue offset, sphere radius
# or None for the plane z = 0.5); the radius 0.25 passes through grid
# vertices, which the offset puts within the snapping tolerance
LS_CASES = dict(sphere=(0.0, 0.3), plane=(0.0, None), snapped=(1e-9, 0.25))
FILES = ("fields.sol", "m.vtu", "p.pvtu", "p_0.vtu", "p_1.vtu")


def linear_fields(v):
    """The `(1, 3)` field of the tests: 1 + x + 2y + 3z and (y, z, x)."""
    return np.stack([1 + v[:, 0] + 2 * v[:, 1] + 3 * v[:, 2],
                     v[:, 1], v[:, 2], v[:, 0]], axis=1)


def ls_input(case: str, unit_cube):
    """(raw cube, level set [n, 1]) of a level-set case."""
    off, radius = LS_CASES[case]
    raw = unit_cube(4)
    v = raw["verts"]
    ls = (v[:, 2] - 0.5 if radius is None
          else np.linalg.norm(v - 0.5, axis=1) - radius) + off
    return raw, ls[:, None]


def ls_mesh(case: str, from_numpy, unit_cube, **kw):
    """A level-set case's input mesh, carrying the linear field."""
    raw, ls = ls_input(case, unit_cube)
    return from_numpy(raw["verts"], raw["tets"], trias=raw["trias"],
                      trrefs=raw["trrefs"], ls=ls,
                      fields=linear_fields(raw["verts"]),
                      field_ncomp=(1, 3), **kw)


def jax_ls_fields(tmp) -> dict:
    """The JAX side of the fields, level-set and VTK checks (in the child
    process): the discretized cases, the adaptation of the discretized
    sphere, the files its output writes and what `load_vtu` reads."""
    import jax
    import jax.numpy as jnp

    from parmmg_tpu.core.mesh import Mesh
    from parmmg_tpu.io import medit, vtk
    from parmmg_tpu.models import adapt as j_adapt
    from parmmg_tpu.models.levelset import discretize_levelset
    from parmmg_tpu.utils import gen as j_gen

    out = {}
    for case in LS_CASES:
        put_mesh(out, f"ls_{case}", discretize_levelset(ls_mesh(
            case, Mesh.from_numpy, j_gen.unit_cube, dtype=jnp.float64)))
    jm, ji = j_adapt.adapt(discretize_levelset(ls_mesh(
        "sphere", Mesh.from_numpy, j_gen.unit_cube, dtype=jnp.float64)),
        j_adapt.AdaptOptions(**LS_CASE))
    out.update({f"hist/{k}": np.asarray([r[k] for r in ji["history"]])
                for k in HIST_KEYS})
    out["status"] = np.asarray(int(ji["status"]))
    put_mesh(out, "adapted", jm)
    medit.save_fields(jm, f"{tmp}/fields.sol")
    vtk.save_vtu(jm, f"{tmp}/m.vtu")
    vtk.save_pvtu(jax.tree_util.tree_map(lambda *a: jnp.stack(a), jm, jm),
                  None, f"{tmp}/p.pvtu")
    for name in FILES:
        with open(f"{tmp}/{name}", "rb") as f:
            out[f"file/{name}"] = np.frombuffer(f.read(), np.uint8)
    put_mesh(out, "vtu_loaded", vtk.load_vtu(f"{tmp}/m.vtu"))
    return out


# the ParMesh flows of tests/test_m6_api_io.py:19 (manual) and :50
# (required), the same calls on either package's `api`
API_FLOWS = ("manual", "required")
API_PAIRS = ("get_vertices", "get_tetrahedra", "get_triangles",
             "get_edges")
F32_RTOL = 5e-6


def api_flow(api, unit_cube, flow: str, **kw):
    """A staged `api.ParMesh` of one flow, not run yet."""
    P = api.Param
    raw = unit_cube(3 if flow == "manual" else 2)
    nv = len(raw["verts"])
    pm = api.ParMesh(**kw)
    if flow == "manual":
        pm.set_mesh_size(np_=nv, ne=len(raw["tets"]), nt=len(raw["trias"]))
    pm.set_vertices(raw["verts"])
    pm.set_tetrahedra(raw["tets"])
    pm.set_triangles(raw["trias"], raw["trrefs"])
    if flow == "manual":
        pm.set_metric_sols(np.full(nv, 0.25))
        pm.set_dparameter(P.DPARAM_hgrad, 1.3)
    else:
        pm.set_corner(0)
        pm.set_required_vertex(13)  # the centre vertex of the n=2 cube
        pm.set_metric_sols(np.full(nv, 0.6))
    pm.set_iparameter(P.IPARAM_niter, 1)
    return pm


def api_record(out: dict, key: str, api, pm) -> None:
    """Record the staged ParMesh `pm` of `api` under `key`: its built
    mesh and option values, then run it: status, sizes, parameters read
    back, every getter and the numberings."""
    put_mesh(out, f"{key}/built", pm._build_mesh())
    out[f"{key}/opts"] = np.asarray(repr(sorted(
        (f.name, getattr(pm.opts, f.name))
        for f in dataclasses.fields(pm.opts))))
    out[f"{key}/status"] = np.asarray(int(pm.parmmglib_centralized()))
    out[f"{key}/size"] = np.asarray(pm.get_mesh_size())
    out[f"{key}/params"] = np.asarray(
        [pm.get_iparameter(api.Param.IPARAM_niter),
         pm.get_dparameter(api.Param.DPARAM_hgrad)])
    for g in API_PAIRS:
        out[f"{key}/{g}/0"], out[f"{key}/{g}/1"] = getattr(pm, g)()
    out[f"{key}/met"] = pm.get_metric_sols()
    out[f"{key}/vglo"] = np.asarray(pm.get_vertex_glonum())
    out[f"{key}/tglo"] = np.asarray(pm.get_triangle_glonum())


def jax_api() -> dict:
    """The JAX side of the API flows (in a child process at XLA's
    optimisation level 0: tests/test_torch_distributed.py runs it with
    its `graded` case, whose child has room for it)."""
    from parmmg_tpu import api
    from parmmg_tpu.utils import gen as j_gen

    out = {}
    for flow in API_FLOWS:
        api_record(out, f"api_{flow}", api,
                   api_flow(api, j_gen.unit_cube, flow))
    return out


def torch_api() -> dict:
    """The port's side of the API flows, on the CPU."""
    out = {}
    for flow in API_FLOWS:
        api_record(out, f"api_{flow}", t_api,
                   api_flow(t_api, t_gen.unit_cube, flow, device="cpu"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX run, port run) of the case, and the JAX side of the fields,
    level-set and VTK checks; the child processes work while the port
    adapts."""
    jax_run = start_jax_side(__file__, "jax_adapt",
                             tmp_path_factory.mktemp("adapt"), ())
    tmp = tmp_path_factory.mktemp("lsf")
    jax_ls = start_jax_side(__file__, "jax_ls_fields", tmp, (tmp,),
                            xla_flags=O0)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        torch_run = t_adapt.adapt(
            t_gen.unit_cube_mesh(4, dtype=torch.float64, device="cpu"),
            t_adapt.AdaptOptions(frontier=False, **CASE), device="cpu")
        ls_run = t_adapt.adapt(t_ls.discretize_levelset(ls_mesh(
            "sphere", t_mesh.Mesh.from_numpy, t_gen.unit_cube,
            dtype=torch.float64, device="cpu")),
            t_adapt.AdaptOptions(**LS_CASE), device="cpu")
    finally:
        torch.use_deterministic_algorithms(prev)
    return jax_run(), torch_run, jax_ls(), ls_run


def _tet_rows(s: dict):
    """The live (tet, tref) rows of a mesh state, sorted: the tets as a
    set."""
    rows = np.concatenate([s["tet"], s["tref"][:, None]], axis=1)
    rows = rows[s["tmask"]]
    return rows[np.lexsort(rows.T[::-1])]


def _assert_mesh_leaves(got, ref: dict, key: str, rtol=RTOL,
                        tet_order=True):
    """Every leaf of `got` equal to the JAX mesh stored under `key`
    (floats within `rtol`; 0 asks for bit equality). With
    `tet_order=False` the live tets compare as a set: the reference's
    jitted operators can place a group of new tets in another slot order
    than its op-by-op run, which the port follows (ROADMAP queue 3)."""
    b = got.to_numpy_state()
    if not tet_order:
        a = {k: ref[f"{key}/{k}"] for k in ("tet", "tref", "tmask")}
        np.testing.assert_array_equal(_tet_rows(b), _tet_rows(a))
    for k in t_mesh.LEAVES:
        a = ref[f"{key}/{k}"]
        assert b[k].shape == a.shape, (k, b[k].shape, a.shape)
        if k in ("tet", "tref") and not tet_order:
            continue
        if a.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(b[k], a, rtol=rtol, atol=rtol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a, err_msg=k)
    assert got.field_ncomp == tuple(int(x) for x in ref[f"{key}/field_ncomp"])
    assert got.met_set == bool(ref[f"{key}/met_set"])


def test_adaptation_equals_live_jax(runs, tmp_path):
    """The full-table case, then the fields, level-set and VTK checks
    (module docstring), against the live JAX runs."""
    j, (tm, ti), jls, ls_run = runs
    th = ti["history"]
    assert len(j["hist/sweep"]) == len(th) >= 4
    for i, b in enumerate(th):
        for k in HIST_KEYS:
            assert j[f"hist/{k}"][i] == b[k], (b["sweep"], k,
                                               j[f"hist/{k}"][i], b[k])
    # the case exercises every operator
    for k in ("nsplit", "ncollapse", "nswap", "nmoved"):
        assert sum(r[k] for r in th) > 0, k

    assert int(ti["status"]) == int(j["status"]) == 0
    assert int(tm.ntet) == int(j["ntet"]) and int(tm.npoin) == int(j["npoin"])
    for key in ("qual_in", "qual_out"):
        b = ti[key]
        for k in ("ne", "counts", "nbad", "ninverted", "worst_elt"):
            np.testing.assert_array_equal(j[f"{key}/{k}"],
                                          getattr(b, k).numpy(), k)
        for k in ("qmin", "qavg", "qmax"):
            np.testing.assert_allclose(float(getattr(b, k)),
                                       float(j[f"{key}/{k}"]), rtol=RTOL,
                                       atol=0, err_msg=k)
    np.testing.assert_array_equal(j["len_counts"],
                                  ti["len_out"].counts.numpy())
    assert int(j["len_n_unit"]) == int(ti["len_out"].n_unit)
    a = {k: j[f"mesh/{k}"] for k in t_mesh.LEAVES}
    b = tm.to_numpy_state()
    for k in t_mesh.LEAVES:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=RTOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert conformity.check_mesh(tm).ok
    _check_levelset(jls)
    _check_ls_fields_adapt(jls, ls_run)
    _check_files(jls, tmp_path)


def check_api(r, got):
    """The port's ParMesh flows (`torch_api`) against JAX's (`jax_api`):
    the staged mesh (f32, as `Mesh.from_numpy` defaults in both) and the
    mapped options exactly; after the run, status, sizes, parameters,
    every getter and the numberings with integers equal (the tets as a
    set of rows) and floats within the f32 `_rtol` of
    tests/test_m18_kernels.py (5e-6); the manual flow refined its
    input, the required vertex stayed."""
    for flow in API_FLOWS:
        key = f"api_{flow}"
        assert sorted(k for k in got if k.startswith(key + "/")) == \
            sorted(k for k in r if k.startswith(key + "/")), flow
        # the tets as a set: the reference's jitted swap_23 orders its
        # new tets otherwise than its op-by-op run (ROADMAP queue 3)
        tets = [np.concatenate([x[f"{key}/get_tetrahedra/0"],
                                x[f"{key}/get_tetrahedra/1"][:, None]], 1)
                for x in (got, r)]
        np.testing.assert_array_equal(
            *(t[np.lexsort(t.T[::-1])] for t in tets), err_msg=key)
        for k in (k for k in got if k.startswith(key + "/")):
            if "/get_tetrahedra/" in k:
                continue
            a, b = r[k], got[k]
            assert a.shape == b.shape and a.dtype == b.dtype, (k, a, b)
            if a.dtype.kind == "f" and "/built/" not in k:
                np.testing.assert_allclose(b, a, rtol=F32_RTOL,
                                           atol=F32_RTOL, err_msg=k)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)
        assert int(got[f"{key}/status"]) == 0
    np.testing.assert_array_equal(got["api_manual/params"], [1, 1.3])
    # the manual flow refined its input; the required centre vertex of
    # the other stays where it was
    assert got["api_manual/size"][1] > got["api_manual/built/tmask"].sum()
    centre = got["api_required/built/vert"][13]
    assert (got["api_required/get_vertices/0"] == centre).all(1).any()
def _check_levelset(r):
    """`discretize_levelset` bit for bit on every case (the snapped
    case has vertices within the snapping tolerance); every case splits
    the field linearly."""
    for case in LS_CASES:
        m = ls_mesh(case, t_mesh.Mesh.from_numpy, t_gen.unit_cube,
                    dtype=torch.float64, device="cpu")
        out = t_ls.discretize_levelset(m)
        _assert_mesh_leaves(out, r, f"ls_{case}", rtol=0)
        d = out.to_numpy()
        np.testing.assert_allclose(d["fields"], linear_fields(d["verts"]),
                                   rtol=1e-14, atol=1e-14)
        # the plane runs along a vertex layer and cuts no tet
        niso = (d["trrefs"] == t_ls.REF_ISO).sum()
        assert (niso > 0) == (LS_CASES[case][1] is not None), case
    raw, ls = ls_input("snapped", t_gen.unit_cube)
    assert (np.abs(ls) < 1e-8).sum() > 0


def _check_ls_fields_adapt(r, run):
    """The discretized sphere with its field through `adapt()`: history,
    status and mesh against JAX; the linear field stays linear."""
    tm, ti = run
    th = ti["history"]
    assert len(r["hist/sweep"]) == len(th) >= 4
    for i, b in enumerate(th):
        for k in HIST_KEYS:
            assert r[f"hist/{k}"][i] == b[k], (b["sweep"], k,
                                               r[f"hist/{k}"][i], b[k])
    assert int(ti["status"]) == int(r["status"]) == 0
    _assert_mesh_leaves(tm, r, "adapted", tet_order=False)
    d = tm.to_numpy()
    assert d["fields"].shape[1] == 4 and d["ls"].shape[1] == 1
    np.testing.assert_allclose(d["fields"], linear_fields(d["verts"]),
                               rtol=1e-12, atol=1e-12)
    assert conformity.check_mesh(tm).ok


def _check_files(r, tmp_path):
    """The files of the adapted mesh (taken from the JAX side) byte for
    byte; `load_vtu` of JAX's file gives JAX's `load_vtu` leaves."""
    m = to_torch(r, "adapted")
    t_medit.save_fields(m, str(tmp_path / "fields.sol"))
    t_vtk.save_vtu(m, str(tmp_path / "m.vtu"))
    t_vtk.save_pvtu(stack_meshes([m, m]), None, str(tmp_path / "p.pvtu"))
    for name in FILES:
        got = np.frombuffer((tmp_path / name).read_bytes(), np.uint8)
        np.testing.assert_array_equal(got, r[f"file/{name}"], err_msg=name)
    (tmp_path / "jax.vtu").write_bytes(r["file/m.vtu"].tobytes())
    loaded = t_vtk.load_vtu(str(tmp_path / "jax.vtu"), device="cpu")
    _assert_mesh_leaves(loaded, r, "vtu_loaded", rtol=0)
    vals, ncomp = t_medit.load_fields(str(tmp_path / "fields.sol"))
    assert ncomp == (1, 3)
    np.testing.assert_allclose(vals, m.to_numpy()["fields"], rtol=1e-14)


def test_cli_round_trip(tmp_path, monkeypatch, capsys):
    """The CLI loads, adapts with its defaults (frontier sweeps) and with
    `-nofrontier` (full-table sweeps), and writes mesh + metric: each
    output reloads to the mesh `adapt()` gives on the same input and
    options, conforming, and the two outputs differ where `adapt()`'s
    do (on this small case neither does). Then the fields, level-set
    and VTK paths (`_check_cli_fields_ls_vtu`)."""
    raw = t_gen.unit_cube(3)
    src = str(tmp_path / "cube3.mesh")
    t_medit.save_mesh(t_mesh.Mesh.from_numpy(
        raw["verts"], raw["tets"], trias=raw["trias"], trrefs=raw["trrefs"],
        device="cpu"), src)
    seen = []
    real_adapt = t_adapt.adapt

    def spy(mesh, opts, **kw):
        seen.append(opts.frontier)
        return real_adapt(mesh, opts, **kw)

    got, ref = {}, {}
    for frontier, extra in ((True, []), (False, ["-nofrontier"])):
        out = str(tmp_path / f"o{int(frontier)}.mesh")
        with monkeypatch.context() as mp:
            mp.setattr(t_adapt, "adapt", spy)
            assert t_cli.main([src, "-hsiz", "0.3", "-niter", "2", "-v",
                               "0", "-out", out] + extra, device="cpu") == 0
        assert seen.pop() is frontier
        m = t_medit.load_mesh(out, t_medit.met_filename(out), device="cpu")
        assert conformity.check_mesh(m).ok
        got[frontier] = m.to_numpy()
        ref[frontier] = t_adapt.adapt(
            t_medit.load_mesh(src, device="cpu"),
            t_adapt.AdaptOptions(hsiz=0.3, niter=2, frontier=frontier),
            device="cpu")[0].to_numpy()
        a, b = got[frontier], ref[frontier]
        assert len(a["tets"]) > 162
        for k in ("tets", "trias", "trrefs", "edges"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a["verts"], b["verts"])
        np.testing.assert_allclose(a["met"], 0.3, rtol=1e-7)

    def same(d):
        return [d[True][k].shape == d[False][k].shape
                and np.array_equal(d[True][k], d[False][k])
                for k in ("tets", "verts")]

    assert same(got) == same(ref)
    _check_cli_fields_ls_vtu(src, tmp_path, capsys)


def _check_cli_fields_ls_vtu(src, tmp_path, capsys):
    """`-field` (its `<out>.fields.sol`), `-ls` with a `.vtu` output,
    a `.vtu` input with a `.pvtu` name (which gets the `.vtu` content),
    each file byte for byte what the API's run on the same input writes;
    a `-field` file of the wrong length, and `-field` with
    `-distributed-input`, exit 1 with the JAX package's messages."""
    v = t_medit.read_mesh(src).verts
    fsol, lsol = str(tmp_path / "f.sol"), str(tmp_path / "ls.sol")
    t_medit.save_sol(fsol, linear_fields(v), [1, 2])
    t_medit.save_sol(lsol, np.linalg.norm(v - 0.5, axis=1)[:, None] - 0.3,
                     [1])
    opts = t_adapt.AdaptOptions(hsiz=0.3, niter=1)
    cli = ["-hsiz", "0.3", "-niter", "1", "-v", "0"]

    def api(mesh, path, save):
        save(t_adapt.adapt(mesh, opts, device="cpu")[0], path)
        return pathlib.Path(path).read_bytes()

    out = str(tmp_path / "of.mesh")
    assert t_cli.main([src, "-field", fsol, "-out", out] + cli,
                      device="cpu") == 0
    m = t_medit.load_mesh(src, device="cpu")
    vals, ncomp = t_medit.load_fields(fsol)
    m = m.replace(fields=torch.as_tensor(np.pad(
        vals, ((0, m.pcap - len(v)), (0, 0))), dtype=m.dtype),
        field_ncomp=ncomp)
    assert api(m, str(tmp_path / "api.sol"), t_medit.save_fields) \
        == (tmp_path / "of.fields.sol").read_bytes()
    vals, ncomp = t_medit.load_fields(str(tmp_path / "of.fields.sol"))
    vo = t_medit.read_mesh(out).verts
    assert ncomp == (1, 3) and len(vals) == len(vo) > len(v)
    np.testing.assert_allclose(vals, linear_fields(vo), rtol=1e-6, atol=1e-6)

    out = str(tmp_path / "ls.vtu")
    assert t_cli.main([src, "-ls", "-sol", lsol, "-out", out] + cli,
                      device="cpu") == 0
    m = t_ls.discretize_levelset(t_medit.raw_to_mesh(
        t_medit.read_mesh(src), ls=t_medit.read_sol(lsol)[0][:, :1],
        device="cpu"))
    assert api(m, str(tmp_path / "api.vtu"), t_vtk.save_vtu) \
        == pathlib.Path(out).read_bytes()
    back = t_vtk.load_vtu(out, device="cpu").to_numpy()
    assert len(back["trias"]) > len(t_medit.read_mesh(src).trias)

    assert t_cli.main([out, "-out", str(tmp_path / "v.pvtu")] + cli,
                      device="cpu") == 0
    assert api(t_vtk.load_vtu(out, device="cpu"),
               str(tmp_path / "api2.vtu"), t_vtk.save_vtu) \
        == (tmp_path / "v.pvtu").read_bytes()

    t_medit.save_sol(fsol, linear_fields(v)[1:], [1, 2])
    capsys.readouterr()
    assert t_cli.main([src, "-field", fsol] + cli, device="cpu") == 1
    assert (f"-field has {len(v) - 1} entries for {len(v)} vertices"
            in capsys.readouterr().err)
    assert t_cli.main([src, "-field", fsol, "-distributed-input"] + cli,
                      device="cpu") == 1
    assert "Distributed fields input not yet implemented" \
        in capsys.readouterr().err


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _assert_no_jax_imports():
    files = sorted((ROOT / "parmmg_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "parmmg_tpu"), (f, mod)
    # the C shim imports the port's modules only
    shim = (ROOT / "parmmg_tpu_torch/native/parmmg_capi.c").read_text()
    mods = re.findall(r'"(parmmg_tpu[\w.]*)"', shim)
    assert mods and all(m.startswith("parmmg_tpu_torch.") for m in mods)
    assert "jax" not in shim


def _assert_no_device_and_no_cuda_raises(monkeypatch, tmp_path):
    m = t_gen.unit_cube_mesh(2, device="cpu")
    src = str(tmp_path / "c.mesh")
    t_medit.save_mesh(m, src)
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_adapt.adapt(m, t_adapt.AdaptOptions(niter=1))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_gen.unit_cube_mesh(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_api.ParMesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cli.main([src, "-hsiz", "0.5", "-niter", "1", "-v", "0"])


UNPORTED_OPTIONS = [
    ("checkpoint_dir", "ck"),
    ("checkpoint_store", "mem://b"), ("faults", "it0:remesh:nan"),
    ("govern", True), ("kernels", "off"), ("validate", "full"),
    ("validate_every", 2), ("recovery_attempts", 0),
    ("checkpoint_every", 2), ("checkpoint_async", True),
    ("checkpoint_keep", 3), ("watchdog_timeout", 30.0),
]

UNPORTED_FLAGS = [
    ["-ckpt", "ck"], ["-ckpt-every", "2"], ["-ckpt-async"],
]

# flags ported since: each runs (on the cube n=2, one iteration) and
# writes the files it names (in the test's directory, the -out name
# given last)
PORTED_FLAGS = [
    (["-rn"], "o.mesh", ["o.mesh", "o.sol"]),
    (["-pure-partitioning", "-nparts", "2"], "p.meshb",
     ["p.0.meshb", "p.1.meshb"]),
    (["-distributed-output"], "o.mesh", ["o.0.mesh", "o.0.sol"]),
    (["-distributed-output", "-nparts", "2"], "d.pvtu",
     ["d.pvtu", "d_0.vtu", "d_1.vtu"]),
]


def _assert_unported_refused(tmp_path):
    m = t_gen.unit_cube_mesh(2, device="cpu")
    for field, value in UNPORTED_OPTIONS:
        opts = t_adapt.AdaptOptions(niter=1, **{field: value})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_adapt.adapt(m, opts, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        t_api.ParMesh(device="cpu").set_checkpoint("ck")
    # a mesh carrying a field adapts, and the field follows the vertices
    raw = t_gen.unit_cube(2)
    mf = t_mesh.Mesh.from_numpy(raw["verts"], raw["tets"],
                                fields=raw["verts"][:, :1],
                                field_ncomp=(1,), device="cpu")
    out, info = t_adapt.adapt(mf, t_adapt.AdaptOptions(niter=1, hsiz=0.3),
                              device="cpu")
    assert int(info["status"]) == 0 and int(out.ntet) > 48
    d = out.to_numpy()
    np.testing.assert_allclose(d["fields"][:, 0], d["verts"][:, 0],
                               atol=1e-6)
    src = str(tmp_path / "r.mesh")
    t_medit.save_mesh(m, src)
    for extra in UNPORTED_FLAGS:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_cli.main([src, "-v", "0"] + extra, device="cpu")
    base = ["-v", "0", "-niter", "1", "-hsiz", "0.5", "-mesh-size", "8"]
    for extra, out, written in PORTED_FLAGS:
        assert t_cli.main([src, "-out", str(tmp_path / out)] + base
                          + extra, device="cpu") == 0, extra
        for name in written:
            assert (tmp_path / name).exists(), (extra, name)
    # the per-rank files of -pure-partitioning as -distributed-input
    assert t_cli.main([str(tmp_path / "p.meshb"), "-distributed-input",
                       "-nparts", "2", "-out", str(tmp_path / "q.mesh")]
                      + base, device="cpu") == 0
    st, comm = t_medit.load_mesh_distributed(str(tmp_path / "q.mesh"), 2,
                                             device="cpu")
    assert int(st.tmask.sum()) > 48 and int(comm.counts.sum()) > 0
    # reloaded conforming: interior vertices numbered, shards merged
    st = t_distr.assign_global_ids(st)
    merged = t_distr.merge_shards(st, t_distr.rebuild_comm(st))
    assert conformity.check_mesh(merged).ok


def _assert_validation_rolls_back(monkeypatch):
    """A non-finite coordinate after an iteration fails `basic`
    validation: the run ends LOWFAILURE with the iteration-start mesh."""
    real = t_adapt.run_batched_sweep_loop

    def poisoned(mesh, *a, **kw):
        mesh = real(mesh, *a, **kw)
        vert = mesh.vert.clone()
        vert[0, 0] = float("nan")
        return mesh.replace(vert=vert)

    with monkeypatch.context() as mp:
        mp.setattr(t_adapt, "run_batched_sweep_loop", poisoned)
        m = t_gen.unit_cube_mesh(2, dtype=torch.float64, device="cpu")
        out, info = t_adapt.adapt(
            m, t_adapt.AdaptOptions(hsiz=0.4, niter=2), device="cpu")
    assert info["status"] == tags.ReturnStatus.LOWFAILURE
    assert info["history"][-1]["error"] == "NumericalError"
    assert int(out.ntet) == 48 and torch.isfinite(out.vert).all()


def _assert_native_tokenizer(cube_mesh_path, tmp_path):
    """The native Medit tokenizer builds here (g++) and gives the Python
    tokenizer's tokens on the cube fixture and on a file with comments;
    `load_mesh` reads through it."""
    from parmmg_tpu_torch.io import native_io

    assert native_io.available()
    commented = tmp_path / "commented.mesh"
    commented.write_text("# head\nMeshVersionFormatted 2 #x\r\n"
                         "Dimension\t3\n\nVertices 0 End")
    for path in (cube_mesh_path, str(commented)):
        with open(path) as f:
            py = re.compile(r"#.*").sub(" ", f.read()).split()
        assert native_io.tokenize(path) == py
    assert t_medit._tokenize(str(commented)) == native_io.tokenize(
        str(commented))


def _shim(monkeypatch):
    """The port's C ABI shim, built here with gcc and loaded into this
    process with ctypes, its handles on the CPU (`capi_support.device`,
    set from Python)."""
    from parmmg_tpu_torch import capi_support, native

    monkeypatch.setattr(capi_support, "device", "cpu")
    lib = ctypes.CDLL(native.capi_library())
    C = ctypes
    dp, ip, vp = C.POINTER(C.c_double), C.POINTER(C.c_int), C.c_void_p
    sigs = dict(
        init=([C.c_int], vp), free=([vp], C.c_int),
        set_vertices=([vp, dp, ip, C.c_int], C.c_int),
        set_tetrahedra=([vp, ip, ip, C.c_int], C.c_int),
        set_triangles=([vp, ip, ip, C.c_int], C.c_int),
        set_metric=([vp, dp, C.c_int, C.c_int], C.c_int),
        set_iparameter=([vp, C.c_int, C.c_int], C.c_int),
        set_dparameter=([vp, C.c_int, C.c_double], C.c_int),
        run=([vp], C.c_int), get_meshsize=([vp, ip, ip, ip], C.c_int),
        get_vertices=([vp, dp, ip, C.c_int], C.c_int),
        get_tetrahedra=([vp, ip, ip, C.c_int], C.c_int),
        get_triangles=([vp, ip, ip, C.c_int], C.c_int),
        get_metric=([vp, dp, C.c_int, C.c_int], C.c_int),
        adapt_file=([C.c_char_p, C.c_char_p, C.c_char_p, C.c_double,
                     C.c_int, C.c_int], C.c_int),
        version=([], C.c_char_p))
    for name, (args, res) in sigs.items():
        fn = getattr(lib, f"pmmgtpu_{name}")
        fn.argtypes, fn.restype = args, res
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(
        ctypes.c_double if a.dtype == np.float64 else ctypes.c_int))


def _assert_shim_equals_parmesh(monkeypatch, tmp_path):
    """The staged-arrays flow of tests/test_native_io.py:45 through the
    shim (1-based) gives the port's `ParMesh` results for the same calls
    bit for bit; `pmmgtpu_adapt_file` writes the bytes `api.adapt_file`
    writes; `pmmgtpu_version` names the port."""
    lib = _shim(monkeypatch)
    P = t_api.Param
    raw = t_gen.unit_cube(3)
    verts = np.ascontiguousarray(raw["verts"], np.float64)
    trrefs = np.ascontiguousarray(raw["trrefs"], np.int32)
    met = np.full((len(verts), 1), 0.25)
    h = ctypes.c_void_p(lib.pmmgtpu_init(1))
    assert h.value
    for rc in (
            lib.pmmgtpu_set_vertices(h, _ptr(verts), None, len(verts)),
            lib.pmmgtpu_set_tetrahedra(
                h, _ptr(np.ascontiguousarray(raw["tets"] + 1, np.int32)),
                None, len(raw["tets"])),
            lib.pmmgtpu_set_triangles(
                h, _ptr(np.ascontiguousarray(raw["trias"] + 1, np.int32)),
                _ptr(trrefs), len(trrefs)),
            lib.pmmgtpu_set_metric(h, _ptr(met), len(verts), 1),
            lib.pmmgtpu_set_iparameter(h, int(P.IPARAM_niter), 1),
            lib.pmmgtpu_set_dparameter(h, int(P.DPARAM_hsiz), 0.25),
            lib.pmmgtpu_run(h)):
        assert rc == 0
    pm = t_api.ParMesh(device="cpu")
    pm.set_vertices(verts)
    pm.set_tetrahedra(raw["tets"])
    pm.set_triangles(raw["trias"], trrefs)
    pm.set_metric_sols(met)
    pm.set_iparameter(P.IPARAM_niter, 1)
    pm.set_dparameter(P.DPARAM_hsiz, 0.25)
    assert pm.parmmglib_centralized() == 0
    n = [ctypes.c_int() for _ in range(3)]
    assert lib.pmmgtpu_get_meshsize(h, *map(ctypes.byref, n)) == 0
    npo, ne, nt = (x.value for x in n)
    assert (npo, ne, nt) == pm.get_mesh_size()[:3] and ne > len(raw["tets"])
    want = dict(vertices=pm.get_vertices(), tetrahedra=pm.get_tetrahedra(),
                triangles=pm.get_triangles())
    for what, cnt, cols, dt in (("vertices", npo, 3, np.float64),
                                ("tetrahedra", ne, 4, np.int32),
                                ("triangles", nt, 3, np.int32)):
        a, refs = np.empty((cnt, cols), dt), np.empty(cnt, np.int32)
        assert getattr(lib, f"pmmgtpu_get_{what}")(
            h, _ptr(a), _ptr(refs), cnt) == 0
        base = 0 if what == "vertices" else 1  # 1-based connectivity
        np.testing.assert_array_equal(a, want[what][0] + base, what)
        np.testing.assert_array_equal(refs, want[what][1], what)
    m_out = np.empty((npo, 1))
    assert lib.pmmgtpu_get_metric(h, _ptr(m_out), npo, 1) == 0
    np.testing.assert_array_equal(m_out, pm.get_metric_sols())
    assert lib.pmmgtpu_free(h) == 0

    src, out = str(tmp_path / "shim_in.mesh"), tmp_path / "shim_out.mesh"
    t_medit.save_mesh(t_gen.unit_cube_mesh(2, device="cpu"), src)
    assert lib.pmmgtpu_adapt_file(src.encode(), b"", str(out).encode(),
                                  0.4, 1, 1) == 0
    assert t_api.adapt_file(src, "", str(tmp_path / "api_out.mesh"), 0.4,
                            1, 1, device="cpu") == 0
    assert out.read_bytes() == (tmp_path / "api_out.mesh").read_bytes()
    assert lib.pmmgtpu_version().decode().startswith("parmmg_tpu_torch ")


def test_rules_of_the_port(monkeypatch, tmp_path, cube_mesh_path):
    """No JAX in the port (nor in its C shim); no silent CPU fallback;
    every unported option and flag refused naming its ROADMAP item, the
    ported distributed flags run; `basic` validation rolls a failed
    iteration back; the native tokenizer and the C ABI shim build here
    and agree with the Python tokenizer and the port's `ParMesh`."""
    _assert_no_jax_imports()
    _assert_no_device_and_no_cuda_raises(monkeypatch, tmp_path)
    _assert_unported_refused(tmp_path)
    _assert_validation_rolls_back(monkeypatch)
    _assert_native_tokenizer(cube_mesh_path, tmp_path)
    _assert_shim_equals_parmesh(monkeypatch, tmp_path)
