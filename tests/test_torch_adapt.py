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
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from parmmg_tpu_torch import __main__ as t_cli
from parmmg_tpu_torch.core import mesh as t_mesh
from parmmg_tpu_torch.core import tags
from parmmg_tpu_torch.io import medit as t_medit
from parmmg_tpu_torch.models import adapt as t_adapt
from parmmg_tpu_torch.utils import conformity, gen as t_gen
from test_torch_ops import one_torch_thread, start_jax_side  # noqa: F401

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX run, port run) of the case; the JAX run's child process
    works while the port adapts."""
    jax_run = start_jax_side(__file__, "jax_adapt",
                             tmp_path_factory.mktemp("adapt"), ())
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        torch_run = t_adapt.adapt(
            t_gen.unit_cube_mesh(4, dtype=torch.float64, device="cpu"),
            t_adapt.AdaptOptions(frontier=False, **CASE), device="cpu")
    finally:
        torch.use_deterministic_algorithms(prev)
    return jax_run(), torch_run


def test_adaptation_equals_live_jax(runs):
    j, (tm, ti) = runs
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


def test_cli_round_trip(tmp_path, monkeypatch):
    """The CLI loads, adapts with its defaults (frontier sweeps) and with
    `-nofrontier` (full-table sweeps), and writes mesh + metric: each
    output reloads to the mesh `adapt()` gives on the same input and
    options, conforming, and the two outputs differ where `adapt()`'s
    do (on this small case neither does)."""
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
            t_cli.main([src, "-hsiz", "0.5", "-niter", "1", "-v", "0"])


UNPORTED_OPTIONS = [
    ("checkpoint_dir", "ck"),
    ("checkpoint_store", "mem://b"), ("faults", "it0:remesh:nan"),
    ("govern", True), ("kernels", "off"), ("validate", "full"),
]

UNPORTED_FLAGS = [
    ["-distributed-output"], ["-distributed-input"],
    ["-field", "f.sol"], ["-ls"], ["-ckpt", "ck"], ["-ckpt-every", "2"],
    ["-ckpt-async"], ["-rn"], ["-pure-partitioning"], ["-out", "o.vtu"],
]


def _assert_unported_refused(tmp_path):
    m = t_gen.unit_cube_mesh(2, device="cpu")
    for field, value in UNPORTED_OPTIONS:
        opts = t_adapt.AdaptOptions(niter=1, **{field: value})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_adapt.adapt(m, opts, device="cpu")
    raw = t_gen.unit_cube(2)
    mf = t_mesh.Mesh.from_numpy(raw["verts"], raw["tets"],
                                fields=np.zeros(len(raw["verts"])),
                                field_ncomp=(1,), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        t_adapt.adapt(mf, t_adapt.AdaptOptions(niter=1), device="cpu")
    src = str(tmp_path / "r.mesh")
    t_medit.save_mesh(m, src)
    for extra in UNPORTED_FLAGS:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_cli.main([src, "-v", "0"] + extra, device="cpu")


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


def test_rules_of_the_port(monkeypatch, tmp_path):
    """No JAX in the port; no silent CPU fallback; every unported option
    and flag refused naming its ROADMAP item; `basic` validation rolls a
    failed iteration back."""
    _assert_no_jax_imports()
    _assert_no_device_and_no_cuda_raises(monkeypatch, tmp_path)
    _assert_unported_refused(tmp_path)
    _assert_validation_rolls_back(monkeypatch)
