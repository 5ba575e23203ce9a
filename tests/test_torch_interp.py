"""Point location, interpolation and the `interp_bary` kernel of the port
held against the JAX package on the CPU.

The JAX side runs in child processes (`test_torch_ops.jax_side`), which
build the inputs from seeds with numpy, run the JAX functions, and hand
inputs and outputs back as numpy arrays; the port then runs here on the
same inputs. The children compile with XLA's backend optimisation level
0 (`--xla_backend_optimization_level=0`) and one Eigen thread: that cuts
their compile time and their share of the suite's cores, and their CPU
code then rounds every multiply and add separately, as the port does (at
the default level XLA contracts multiply-adds, ROADMAP queue 3).

Integer outputs (located tets, seeds, flags, walk steps, trias) must be
equal, on fixtures whose query points are strictly inside their tets or
have one nearest tria. Floats agree within `_rtol` of
tests/test_m18_kernels.py (5e-11 at f64, 5e-6 at f32) relative to the
row's magnitude scale, which is 1 for barycentric weights and the value
itself for sizes and metric tensors. The fixtures are those of
tests/test_m2_interp.py and tests/test_m18_kernels.py.
"""

import numpy as np
import pytest
import torch

from parmmg_tpu_torch import kernels as tk
from parmmg_tpu_torch.core.mesh import LEAVES, Mesh
from parmmg_tpu_torch.kernels import interp_k
from parmmg_tpu_torch.ops import interp as t_interp
from parmmg_tpu_torch.ops import locate as t_loc
from parmmg_tpu_torch.parallel.distribute import stack_meshes, unstack_mesh
from test_torch_ops import jax_side, one_torch_thread  # noqa: F401

RTOL = {np.dtype(np.float32): 5e-6, np.dtype(np.float64): 5e-11}
O0 = "--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false"
# the parts of the JAX side, grouped into two child processes
CHILDREN = (("kernel", "locate", "surface"), ("stacked", "driver"))


def _put_mesh(out: dict, key: str, jm) -> None:
    for k in LEAVES:
        out[f"{key}/{k}"] = np.asarray(getattr(jm, k))
    out[f"{key}/met_set"] = np.asarray(bool(jm.met_set))


def _mesh(ref: dict, key: str) -> Mesh:
    return Mesh.from_jax_state({k: ref[f"{key}/{k}"] for k in LEAVES},
                               device="cpu",
                               met_set=bool(ref[f"{key}/met_set"]))


def _spd6(rng, n, h):
    A = rng.normal(scale=0.5, size=(n, 3, 3)) + np.eye(3)
    M = (A @ np.transpose(A, (0, 2, 1)) + 0.1 * np.eye(3)) / h ** 2
    return M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]


def _ls_of(v):
    """A level set on the points `v`: the distance to the cube's centre
    less 0.3."""
    return (np.linalg.norm(v - 0.5, axis=1) - 0.3)[:, None]


def _fields_of(v):
    """A (1, 3) field on the points `v`, one part of it not linear."""
    return np.stack([1 + v[:, 0] * v[:, 1] + 2 * v[:, 2], v[:, 1],
                     v[:, 2] ** 2, v[:, 0]], axis=1)


# ---------------------------------------------------------------------------
# the JAX side (child process)
# ---------------------------------------------------------------------------


def _jax_kernel(out):
    """interp_bary through the lax reference and the Pallas body
    (interpret mode) on a real mesh's tets (test_m18's fixture), f32 and
    f64, C = 1; C = 6 through the reference."""
    import jax.numpy as jnp

    from parmmg_tpu import kernels
    from parmmg_tpu.kernels import registry
    from parmmg_tpu.utils.gen import unit_cube_mesh

    for dn, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
        mesh = unit_cube_mesh(4, dtype=dt)
        rng = np.random.default_rng(13)
        Q = 1024
        tids = rng.integers(0, int(mesh.ntet), size=Q)
        vids = np.asarray(mesh.tet)[tids].astype(np.int32)
        vert = np.asarray(mesh.vert)
        met = rng.uniform(0.05, 0.4, size=(vert.shape[0], 1)).astype(dt)
        met6 = _spd6(rng, vert.shape[0], 0.2).astype(dt)
        pts = rng.uniform(0.0, 1.0, size=(Q, 3)).astype(dt)
        out.update({f"{dn}/vert": vert, f"{dn}/met": met,
                    f"{dn}/met6": met6, f"{dn}/vids": vids,
                    f"{dn}/pts": pts})
        args = [jnp.asarray(a) for a in (vert, met, vids, pts)]
        for mode in ("off", "on"):
            with registry.use_mode(mode):
                b, m = kernels.interp_bary(*args)
            out[f"{dn}/{mode}/bary"], out[f"{dn}/{mode}/met"] = \
                np.asarray(b), np.asarray(m)
        args[1] = jnp.asarray(met6)
        with registry.use_mode("on"):
            b, m = kernels.interp_bary(*args)
        out[f"{dn}/aniso/bary"], out[f"{dn}/aniso/met"] = \
            np.asarray(b), np.asarray(m)


def _jax_locate(out):
    """Location on test_m2's perturbed cube: barycoords, seeds, the walk,
    the exhaustive search and the host-orchestrated locate."""
    import jax.numpy as jnp

    from parmmg_tpu.ops import locate
    from parmmg_tpu.utils import gen

    cube8 = gen.unit_cube_mesh(8, dtype=jnp.float64, perturb=0.15)
    _put_mesh(out, "cube8", cube8)
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.05, 0.95, (500, 3))
    # far seeds, so the walk takes many steps
    seeds = rng.integers(0, int(cube8.ntet), size=500).astype(np.int32)
    far = np.array([[1.5, 0.5, 0.5], [0.5, -0.3, 0.5], [0.5, 0.5, 0.5]])
    out.update(pts=pts, seeds=seeds, far=far)
    c = np.asarray(cube8.vert)[np.asarray(cube8.tet)[seeds]]
    lam = locate.tet_barycoords(jnp.asarray(c), jnp.asarray(pts))
    out["lam"], out["clamped"] = np.asarray(lam), \
        np.asarray(locate.clamp_bary(lam))
    out["morton"] = np.asarray(locate.morton_seeds(cube8, jnp.asarray(pts)))
    for key, sd in (("walk_m", out["morton"]), ("walk_far", seeds)):
        r = locate.walk_locate(cube8, jnp.asarray(pts), jnp.asarray(sd),
                               max_steps=64)
        for f in r._fields:
            out[f"{key}/{f}"] = np.asarray(getattr(r, f))
    t, b = locate.exhaustive_locate(cube8, jnp.asarray(
        np.concatenate([far, pts[:20]])))
    out["exh/tet"], out["exh/bary"] = np.asarray(t), np.asarray(b)
    r = locate.locate_points(cube8, jnp.asarray(np.concatenate([far, pts])))
    for f in r._fields:
        out[f"lp/{f}"] = np.asarray(getattr(r, f))


def _jax_surface(out):
    """tria_barycoords and bdy_locate: test_m2's inward-nudged surface
    queries on the n=4 cube, with and without query normals, and its
    cross-ridge fixture (two sheets at 90 degrees)."""
    import jax.numpy as jnp

    from parmmg_tpu.core.mesh import Mesh as JMesh
    from parmmg_tpu.ops import analysis, locate
    from parmmg_tpu.utils import gen

    old = analysis.mark_boundary(gen.unit_cube_mesh(4, dtype=jnp.float64))
    _put_mesh(out, "cube4", old)
    smask = analysis.surf_tria_mask(old)
    sm = np.asarray(smask)
    bc = np.asarray(old.vert)[np.asarray(old.tria)[sm]].mean(axis=1)
    nrm = np.asarray(analysis.tria_normals(old)[0])[sm]
    pts = bc - 0.05 * nrm
    out.update(spts=pts, snrm=nrm)
    c = np.asarray(old.vert)[np.asarray(old.tria)[sm]]
    out["tri_lam"] = np.asarray(locate.tria_barycoords(
        jnp.asarray(c), jnp.asarray(pts + 0.01)))
    for key, kw in (("plain", {}), ("normals", dict(normals=jnp.asarray(
            nrm), cos_wedge=0.5))):
        r = locate.bdy_locate(old, smask, jnp.asarray(pts), **kw)
        for f in r._fields:
            out[f"bdy_{key}/{f}"] = np.asarray(getattr(r, f))

    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 0.5, 0], [1, 0.5, 0],
                      [0, 0, -0.5], [1, 0, -0.5]], np.float64)
    trias = np.array([[0, 1, 3], [0, 3, 2], [0, 1, 5], [0, 5, 4]], np.int32)
    ridge = JMesh.from_numpy(verts, np.zeros((0, 4), np.int32), trias=trias,
                             dtype=jnp.float64)
    _put_mesh(out, "ridge", ridge)
    q = np.array([[0.5, 0.0004, -0.001], [0.5, 0.3, 0.002]])
    nq = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    out.update(rq=q, rnq=nq)
    for key, kw in (("plain", {}), ("normals",
                                    dict(normals=jnp.asarray(nq)))):
        r = locate.bdy_locate(ridge, ridge.trmask, jnp.asarray(q),
                              window=8, **kw)
        for f in r._fields:
            out[f"ridge_{key}/{f}"] = np.asarray(getattr(r, f))


def _jax_stacked(out):
    """interp_stacked on test_m2's two-shard rescue fixture: one
    true-surface vertex of shard 0 pushed outside the old domain."""
    import jax
    import jax.numpy as jnp

    from parmmg_tpu.core import tags
    from parmmg_tpu.ops import analysis, interp
    from parmmg_tpu.parallel.distribute import split_mesh, unstack_mesh
    from parmmg_tpu.utils import gen

    mesh = gen.unit_cube_mesh(4, dtype=jnp.float64)
    tm = np.asarray(mesh.tmask)
    bary = np.asarray(mesh.vert)[np.asarray(mesh.tet)].mean(axis=1)
    part = np.where(bary[:, 0] > 0.5, 1, 0)
    part[~tm] = -1
    stacked, _ = split_mesh(mesh, part, 2)
    olds, news = [], []
    for s, m in enumerate(unstack_mesh(stacked)):
        m = analysis.analyze(m)
        vt, vm = np.asarray(m.vtag), np.asarray(m.vmask)
        bdy = ((vt & tags.BDY) != 0) & ((vt & tags.PARBDY) == 0)
        v = np.asarray(m.vert)
        # metric graded along y, 0.1 on the true surface
        met = (0.3 + 0.1 * v[:, 1])[:, None]
        met[bdy] = 0.1
        olds.append(m.replace(met=jnp.asarray(met), met_set=True,
                              ls=jnp.asarray(_ls_of(v)),
                              fields=jnp.asarray(_fields_of(v)),
                              field_ncomp=(1, 3)))
        v = v.copy()
        if s == 0:
            cand = np.nonzero(vm & bdy & ((vt & tags.REQUIRED) == 0))[0]
            out["moved"] = np.asarray(cand[0])
            p = v[cand[0]]
            outward = np.where(p > 0.5, 1.0, np.where(p < 0.5, -1.0, 0.0))
            on_face = (np.abs(p) < 1e-9) | (np.abs(p - 1.0) < 1e-9)
            v[cand[0]] = p + 0.05 * outward * on_face
        # interior vertices moved a little, so interpolation moves values
        rng = np.random.default_rng(s)
        inner = vm & ((vt & (tags.BDY | tags.PARBDY)) == 0)
        v[inner] += rng.uniform(-0.02, 0.02, size=(int(inner.sum()), 3))
        news.append(m.replace(vert=jnp.asarray(v),
                              met=jnp.asarray(np.ones((m.pcap, 1))),
                              ls=jnp.zeros((m.pcap, 1)),
                              fields=jnp.zeros((m.pcap, 4)),
                              field_ncomp=(1, 3)))
    stack = lambda ms: jax.tree_util.tree_map(  # noqa: E731
        lambda *xs: jnp.stack(xs), *ms)
    old, new = stack(olds), stack(news)
    _put_mesh(out, "old", old)
    _put_mesh(out, "new", new)
    _put_mesh(out, "out", interp.interp_stacked(new, old))


def _jax_driver(out):
    """interp_metrics_and_fields of test_m2: the perturbed n=5 cube's
    vertices through the perturbed n=8 cube with a graded size."""
    import jax.numpy as jnp

    from parmmg_tpu.ops import interp
    from parmmg_tpu.utils import gen

    cube8 = gen.unit_cube_mesh(8, dtype=jnp.float64, perturb=0.15)
    v = np.asarray(cube8.vert)
    old = cube8.replace(met=jnp.asarray(
        (0.05 + 0.1 * v[:, 0] + 0.05 * v[:, 1])[:, None]), met_set=True)
    new = gen.unit_cube_mesh(5, dtype=jnp.float64, perturb=0.1)
    _put_mesh(out, "old", old)
    _put_mesh(out, "new", new)
    got, res = interp.interp_metrics_and_fields(new, old)
    _put_mesh(out, "got", got)
    out["found"] = np.asarray(res.found)
    # the fields post-pass: the old mesh carries a level set and a (1, 3)
    # field, the new one zeros (its dead slots included)
    old_f = old.replace(ls=jnp.asarray(_ls_of(v)),
                        fields=jnp.asarray(_fields_of(v)),
                        field_ncomp=(1, 3))
    new_f = new.replace(ls=jnp.zeros((new.pcap, 1)),
                        fields=jnp.zeros((new.pcap, 4)), field_ncomp=(1, 3))
    _put_mesh(out, "old_f", old_f)
    _put_mesh(out, "new_f", new_f)
    _put_mesh(out, "fields_only", interp.interp_fields_only(new_f, old_f))


def jax_interp(*parts) -> dict:
    fns = {"kernel": _jax_kernel, "locate": _jax_locate,
           "surface": _jax_surface, "stacked": _jax_stacked,
           "driver": _jax_driver}
    out = {}
    for part in parts:
        got = {}
        fns[part](got)
        out.update({f"{part}:{k}": v for k, v in got.items()})
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """ref(part): one part of the JAX side. All parts are computed, in
    two child processes side by side, when a test first asks for one."""
    full = {}

    def get(part):
        if not full:
            full.update(jax_side(__file__, "jax_interp",
                                 tmp_path_factory.mktemp("jint"),
                                 *CHILDREN, xla_flags=O0))
        n = len(part) + 1
        return {k[n:]: v for k, v in full.items()
                if k.startswith(part + ":")}

    return get


def _t(a):
    return torch.as_tensor(a)


def _close(got, want, scale=None):
    """|got - want| <= rtol * max(|want|, scale) elementwise."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    rtol = RTOL[want.dtype]
    tol = rtol * np.maximum(np.abs(want), 0.0 if scale is None else scale)
    bad = ~(np.abs(got - want) <= tol)
    assert not bad.any(), (int(bad.sum()), got[bad][:5], want[bad][:5])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_interp_bary_plain_matches_reference_and_pallas(ref):
    """interp_bary_plain against the lax reference and the Pallas body
    (interpret mode): f32 and f64, C = 1; C = 6 on the plain route,
    which the wrapper takes for anisotropic metrics on every device (its
    tensors compared at f64)."""
    r = ref("kernel")
    for dn in ("f32", "f64"):
        vert, met, met6, vids, pts = (_t(r[f"{dn}/{k}"]) for k in
                                      ("vert", "met", "met6", "vids", "pts"))
        b, m = tk.interp_bary_plain(vert, met, vids, pts)
        for mode in ("off", "on"):
            _close(b, r[f"{dn}/{mode}/bary"], scale=1.0)
            _close(m, r[f"{dn}/{mode}/met"])
        assert float(b.min()) >= 0.0
        # the wrapper takes the plain version for CPU tensors, and the
        # stacked call gives each shard its own table
        b1, m1 = tk.interp_bary(vert, met, vids, pts)
        assert torch.equal(b1, b) and torch.equal(m1, m)
        bs, ms = tk.interp_bary(torch.stack([vert, vert.flip(0)]),
                                torch.stack([met, met.flip(0)]),
                                torch.stack([vids, vids]),
                                torch.stack([pts, pts]))
        assert torch.equal(bs[0], b) and torch.equal(ms[0], m)
        bf, mf = tk.interp_bary_plain(vert.flip(0), met.flip(0), vids, pts)
        for a, b_ in ((bs[1], bf), (ms[1], mf)):
            torch.testing.assert_close(a, b_, rtol=0, atol=0,
                                       equal_nan=True)
        # the checks the wrapper makes before a launch take an empty
        # stream, unstacked and stacked, and still refuse a wrong width
        interp_k._check(vert, met, vids[:0], pts[:0])
        interp_k._check(vert[None], met[None], vids[None, :0],
                        pts[None, :0])
        with pytest.raises(ValueError):
            interp_k._check(vert, met, vids[:0, :3], pts[:0])
        b6, m6 = tk.interp_bary(vert, met6, vids, pts)
        _close(b6, r[f"{dn}/aniso/bary"], scale=1.0)
        if dn == "f64":
            # in f32 the two eigensolvers (LAPACK's through torch, XLA's)
            # differ by ~2e-5 relative, beyond f32's `_rtol`
            _close(m6, r[f"{dn}/aniso/met"])


def _check_locate(ref):
    """tet_barycoords, clamp_bary, morton_seeds, walk_locate (from Morton
    seeds and from far random seeds), exhaustive_locate and
    locate_points on random interior points and points outside."""
    r = ref("locate")
    m = _mesh(r, "cube8")
    pts, seeds, far = _t(r["pts"]), _t(r["seeds"]), _t(r["far"])
    lam = t_loc.tet_barycoords(m.vert[m.tet[seeds.long()]], pts)
    _close(lam, r["lam"], scale=1.0)
    _close(t_loc.clamp_bary(lam), r["clamped"], scale=1.0)
    ms = t_loc.morton_seeds(m, pts)
    np.testing.assert_array_equal(ms.numpy(), r["morton"])
    for key, sd in (("walk_m", ms), ("walk_far", seeds)):
        res = t_loc.walk_locate(m, pts, sd, max_steps=64)
        for f in ("tet", "found", "steps"):
            np.testing.assert_array_equal(getattr(res, f).numpy(),
                                          r[f"{key}/{f}"], err_msg=(key, f))
        _close(res.bary, r[f"{key}/bary"], scale=1.0)
    assert int(r["walk_far/steps"].max()) > 8
    assert r["walk_m/found"].all()
    t, b = t_loc.exhaustive_locate(m, torch.cat([far, pts[:20]]))
    np.testing.assert_array_equal(t.numpy(), r["exh/tet"])
    _close(b, r["exh/bary"], scale=1.0)
    res = t_loc.locate_points(m, torch.cat([far, pts]))
    for f in ("tet", "found", "steps"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), r[f"lp/{f}"])
    _close(res.bary, r["lp/bary"], scale=1.0)
    assert not r["lp/found"][:2].any() and r["lp/found"][2:].all()


def _check_surface(ref):
    """tria_barycoords and bdy_locate on inward-nudged surface queries
    (with and without query normals), and the cross-ridge fixture:
    plain distance picks the tria across the ridge, the query normal
    keeps it on its own side."""
    r = ref("surface")
    old = _mesh(r, "cube4")
    from parmmg_tpu_torch.ops import analysis

    smask = analysis.surf_tria_mask(old)
    pts, nrm = _t(r["spts"]), _t(r["snrm"])
    c = old.vert[old.tria[smask].long()]
    _close(t_loc.tria_barycoords(c, pts + 0.01), r["tri_lam"], scale=1.0)
    for key, kw in (("plain", {}), ("normals",
                                    dict(normals=nrm, cos_wedge=0.5))):
        res = t_loc.bdy_locate(old, smask, pts, **kw)
        np.testing.assert_array_equal(res.tria.numpy(),
                                      r[f"bdy_{key}/tria"])
        _close(res.bary, r[f"bdy_{key}/bary"], scale=1.0)
        _close(res.dist, r[f"bdy_{key}/dist"], scale=1.0)
    ridge = _mesh(r, "ridge")
    q, nq = _t(r["rq"]), _t(r["rnq"])
    for key, kw in (("plain", {}), ("normals", dict(normals=nq))):
        res = t_loc.bdy_locate(ridge, ridge.trmask, q, window=8, **kw)
        np.testing.assert_array_equal(res.tria.numpy(),
                                      r[f"ridge_{key}/tria"])
        _close(res.dist, r[f"ridge_{key}/dist"], scale=1.0)
    assert int(r["ridge_plain/tria"][0]) in (2, 3)
    assert int(r["ridge_normals/tria"][0]) in (0, 1)


def _check_stacked(ref):
    """interp_stacked on two shards: one walk and one interp_bary call
    over both shards, the surface path for BDY vertices, and the host
    rescue for the vertex pushed outside the old domain (which keeps
    its surface value, 0.1); the level set and the (1, 3) field the old
    shards carry ride the same weights."""
    r = ref("stacked")
    old, new = _mesh(r, "old"), _mesh(r, "new")
    shards = t_interp.interp_stacked(unstack_mesh(new), unstack_mesh(old))
    assert len(shards) == 2
    out = stack_meshes(shards)
    want = {k: r[f"out/{k}"] for k in LEAVES}
    got = out.to_numpy_state()
    for k in LEAVES:
        if k == "met":
            _close(out.met, want[k])
        elif k in ("ls", "fields"):
            _close(getattr(out, k), want[k], scale=1.0)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    moved = int(r["moved"])
    assert abs(float(out.met[0, moved, 0]) - 0.1) < 1e-12
    # the interpolation moved values, and the snapshot is untouched
    vm = got["vmask"]
    assert np.abs(got["met"][vm] - 1.0).min() > 1e-3
    assert np.abs(got["fields"][vm][:, 0]).min() > 0.5
    for k in LEAVES:
        np.testing.assert_array_equal(old.to_numpy_state()[k],
                                      r[f"old/{k}"], err_msg=k)


def _check_driver(ref):
    """The single-shard driver: every vertex of the new mesh located in
    the old one and its size interpolated (graded metric); and the
    fields post-pass `interp_fields_only` on the same pair, the old mesh
    carrying a level set and a (1, 3) field."""
    r = ref("driver")
    old, new = _mesh(r, "old"), _mesh(r, "new")
    got, res = t_interp.interp_metrics_and_fields(new, old)
    _close(got.met, r["got/met"])
    np.testing.assert_array_equal(res.found.numpy(), r["found"])
    assert r["found"].mean() > 0.9
    # the fields post-pass, dead slots and all
    new_f, old_f = _mesh(r, "new_f"), _mesh(r, "old_f")
    out = t_interp.interp_fields_only(new_f, old_f)
    want = {k: r[f"fields_only/{k}"] for k in LEAVES}
    for k in LEAVES:
        if k in ("ls", "fields"):
            _close(getattr(out, k), want[k], scale=1.0)
        else:
            np.testing.assert_array_equal(getattr(out, k).numpy(), want[k],
                                          err_msg=k)
    vm = want["vmask"]
    assert (~vm).any() and np.abs(want["fields"][vm, 0]).min() > 0.5
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(old_f, k).numpy(),
                                      r[f"old_f/{k}"], err_msg=k)


def test_location_and_interpolation_match_jax(ref):
    """The location functions, the surface location, `interp_stacked`
    with its rescue, and the single-shard interpolation driver, each
    against its live JAX counterpart (see the checks above)."""
    _check_locate(ref)
    _check_surface(ref)
    _check_stacked(ref)
    _check_driver(ref)
