"""Point location in a background tetrahedral mesh.

Counterpart of `parmmg_tpu/ops/locate.py`: all queries walk the
adjacency at once, steered by the sign of their barycentric coordinates,
from seeds given by a Morton sort of tet barycenters; the points the walk
cannot place fall back to an exhaustive closest-element search. Surface
points are located on the boundary triangulation by a windowed search in
a Morton order of tria barycenters.

Sums of a few terms are written out left to right, as XLA evaluates the
reference's reductions; sorts are stable and `searchsorted` is
left-sided, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import sfc
from ..core.mesh import Mesh
from ..kernels.quality_k import _cross, _dot3
from .common import take


def _vol6(a, b, d, e):
    """Six times the signed volume of (a, b, d, e): (b-a) x (d-a) . (e-a)."""
    return _dot3(_cross(b - a, d - a), e - a)


def _tiny(dtype) -> float:
    return float(torch.finfo(dtype).tiny)


def tet_barycoords(c, p):
    """Barycentric coordinates of points in tets.

    c: [...,4,3] tet vertex coords, p: [...,3] points -> [...,4]: the
    signed volume of the tet with vertex i replaced by p over the tet's
    volume."""
    v0, v1, v2, v3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    v = _vol6(v0, v1, v2, v3)
    lam = torch.stack([_vol6(p, v1, v2, v3), _vol6(v0, p, v2, v3),
                       _vol6(v0, v1, p, v3), _vol6(v0, v1, v2, p)], dim=-1)
    tiny = _tiny(p.dtype)
    denom = torch.where(v.abs() > tiny, v,
                        torch.where(v >= 0, tiny, -tiny))
    return lam / denom[..., None]


def clamp_bary(lam):
    """Project barycoords onto the simplex (closest-point behaviour for
    slightly-outside points); the sum runs left to right."""
    lam = torch.clamp(lam, min=0.0)
    s = lam[..., 0]
    for k in range(1, lam.shape[-1]):
        s = s + lam[..., k]
    return lam / torch.clamp(s, min=1e-30)[..., None]


class LocateResult(NamedTuple):
    tet: torch.Tensor    # [Q] int32 containing (or closest) tet slot
    bary: torch.Tensor   # [Q,4] barycentric coords, clamped to the simplex
    found: torch.Tensor  # [Q] bool: located by the walk (not the fallback)
    steps: torch.Tensor  # [Q] int32 walk steps taken


def _mean_rows(c):
    """Mean over axis 1 of [N,K,3] corner coordinates (`jnp.mean`: a
    left-to-right sum, then a true division)."""
    s = c[:, 0]
    for k in range(1, c.shape[1]):
        s = s + c[:, k]
    return s / torch.full((), float(c.shape[1]), dtype=s.dtype,
                          device=s.device)


def _box(pts, live):
    """(lo, hi) of the live rows of [N,3] points."""
    lo = torch.where(live[:, None], pts, torch.inf).min(dim=0).values
    hi = torch.where(live[:, None], pts, -torch.inf).max(dim=0).values
    return lo, hi


def _morton_order(bc, live):
    """(lo, hi, order, sorted keys, live count) of the Morton sort of
    the live rows of `bc`; dead rows sort last."""
    lo, hi = _box(bc, live)
    keys = torch.where(live, sfc.morton_keys(bc, lo, hi), sfc.DEAD_KEY)
    order = torch.argsort(keys, stable=True)
    return lo, hi, order, keys[order].contiguous(), live.sum()


def morton_seeds(mesh: Mesh, pts):
    """[Q] int64 seed tet per query point: the live tet next to the
    query's Morton key in the Morton order of tet barycenters."""
    bc = _mean_rows(take(mesh.vert, mesh.tet))
    lo, hi, order, skeys, nlive = _morton_order(bc, mesh.tmask)
    qkeys = sfc.morton_keys(pts, lo, hi).contiguous()
    pos = torch.searchsorted(skeys, qkeys)
    pos = torch.clamp(pos, min=0)
    pos = torch.minimum(pos, torch.clamp(nlive - 1, min=0))
    return order[pos]


# the walk tests whether any query is still active every this many steps
# (a host sync); frozen queries do not change, so the result is that of
# a test before every step
_WALK_CHECK = 8


def walk_tables(vert, tet, adja, pts, seeds, max_steps: int = 64,
                eps: float | None = None) -> LocateResult:
    """The adjacency walk on raw tables: every active query moves to the
    neighbour across the face of its most negative barycentric coordinate
    until it is inside, blocked at a boundary face, or out of steps."""
    if eps is None:
        # inside tolerance relative to the dtype's epsilon
        eps = max(1e-9, 100.0 * float(torch.finfo(pts.dtype).eps))
    q = pts.shape[0]
    dev = pts.device
    adja_flat = adja.reshape(-1)
    cur = seeds.to(torch.int64)
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    stuck = torch.zeros(q, dtype=torch.bool, device=dev)
    steps = torch.zeros(q, dtype=torch.int32, device=dev)
    for it in range(max_steps):
        if it % _WALK_CHECK == 0 and not bool((~(done | stuck)).any()):
            break
        lam = tet_barycoords(take(vert, take(tet, cur)), pts)
        inside = lam.min(dim=-1).values >= -eps
        face = torch.argmin(lam, dim=-1)
        code = take(adja_flat, cur * 4 + face)
        blocked = code < 0
        active = ~(done | stuck)
        done = done | (active & inside)
        stuck = stuck | (active & ~inside & blocked)
        moving = active & ~inside & ~blocked
        cur = torch.where(moving, torch.div(code.to(torch.int64), 4,
                                            rounding_mode="floor"), cur)
        steps = steps + moving.to(torch.int32)
    lam = tet_barycoords(take(vert, take(tet, cur)), pts)
    done = done | (lam.min(dim=-1).values >= -eps)
    return LocateResult(cur.to(torch.int32), clamp_bary(lam), done, steps)


def walk_locate(mesh: Mesh, pts, seeds, max_steps: int = 64,
                eps: float | None = None) -> LocateResult:
    """Simultaneous adjacency walk for all query points; `mesh.adja`
    must be fresh (`build_adjacency` after any topology change)."""
    return walk_tables(mesh.vert, mesh.tet, mesh.adja, pts, seeds,
                       max_steps, eps)


def exhaustive_locate(mesh: Mesh, pts, tchunk: int = 1024):
    """Best tet per query over all valid tets (the largest minimum
    barycoord; the lowest slot on ties), scanned in chunks of tets.
    Returns (tet [Q] int32, bary [Q,4] clamped)."""
    q = pts.shape[0]
    # bound the [Q, chunk, 4] working set; the answer does not depend on
    # the chunking
    tchunk = max(tchunk, (1 << 22) // max(q, 1))
    best_v = torch.full((q,), -torch.inf, dtype=pts.dtype, device=pts.device)
    best_i = torch.zeros(q, dtype=torch.int64, device=pts.device)
    for start in range(0, mesh.tcap, tchunk):
        tets = mesh.tet[start:start + tchunk]
        mask = mesh.tmask[start:start + tchunk]
        lam = tet_barycoords(take(mesh.vert, tets)[None], pts[:, None])
        mb = torch.where(mask[None, :], lam.min(dim=-1).values, -torch.inf)
        v = mb.max(dim=-1).values
        k = torch.argmax(mb, dim=-1)
        upd = v > best_v
        best_v = torch.where(upd, v, best_v)
        best_i = torch.where(upd, k + start, best_i)
    lam = tet_barycoords(take(mesh.vert, take(mesh.tet, best_i)), pts)
    return best_i.to(torch.int32), clamp_bary(lam)


def tria_barycoords(c, p):
    """Barycentric coords of the projection of p onto the tria plane.

    c: [...,3,3] tria vertex coords, p: [...,3] -> [...,3] coords
    summing to 1."""
    a, b, d = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    v0, v1, v2 = b - a, d - a, p - a
    d00, d01, d11 = _dot3(v0, v0), _dot3(v0, v1), _dot3(v1, v1)
    d20, d21 = _dot3(v2, v0), _dot3(v2, v1)
    denom = d00 * d11 - d01 * d01
    tiny = _tiny(p.dtype)
    denom = torch.where(denom.abs() > tiny, denom,
                        torch.full_like(denom, tiny))
    lv = (d11 * d20 - d01 * d21) / denom
    lw = (d00 * d21 - d01 * d20) / denom
    return torch.stack([(1.0 - lv) - lw, lv, lw], dim=-1)


class BdyLocateResult(NamedTuple):
    tria: torch.Tensor   # [Q] best surface-tria slot
    bary: torch.Tensor   # [Q,3] clamped barycentric coords on that tria
    dist: torch.Tensor   # [Q] distance to the closest point used


# default wedge threshold: cos 45 deg, the default feature angle
_COS_WEDGE = 0.70710678


def _norm3(x):
    return torch.sqrt(_dot3(x, x))


def bdy_locate(mesh: Mesh, surf_mask, pts, window: int = 32, normals=None,
               cos_wedge: float = _COS_WEDGE) -> BdyLocateResult:
    """Locate boundary points on the boundary triangulation: every query
    scans a `window` of surface trias around its position in the Morton
    order of tria barycenters and keeps the one whose clamped closest
    point is nearest. With `normals` ([Q,3] unit query normals, zero
    for none), a candidate whose plane normal deviates from the query's
    past `cos_wedge` is demoted by a distance penalty, so a query near a
    ridge keeps to its own side of the feature."""
    bc3 = _mean_rows(take(mesh.vert, mesh.tria))
    lo, hi, order, skeys, nlive = _morton_order(bc3, surf_mask)
    qkeys = sfc.morton_keys(pts, lo, hi).contiguous()
    pos = torch.searchsorted(skeys, qkeys)
    offs = torch.arange(-window // 2, window - window // 2,
                        device=pts.device)
    cand_pos = torch.clamp(pos[:, None] + offs[None, :], min=0)
    cand_pos = torch.minimum(cand_pos, torch.clamp(nlive - 1, min=0))
    cand = order[cand_pos]                              # [Q,W]
    c = take(mesh.vert, take(mesh.tria, cand))          # [Q,W,3,3]
    lam = clamp_bary(tria_barycoords(c, pts[:, None, :]))
    closest = (lam[..., 0, None] * c[..., 0, :]
               + lam[..., 1, None] * c[..., 1, :]) \
        + lam[..., 2, None] * c[..., 2, :]
    dist = _norm3(closest - pts[:, None, :])
    dist = torch.where(take(surf_mask, cand), dist, torch.inf)
    score = dist
    if normals is not None:
        raw = _cross(c[..., 1, :] - c[..., 0, :], c[..., 2, :] - c[..., 0, :])
        tn = raw / torch.clamp(_norm3(raw), min=1e-30)[..., None]
        dot = _dot3(normals[:, None, :], tn).abs()
        has_n = _norm3(normals) > 0.5
        wrong_side = has_n[:, None] & (dot < cos_wedge)
        pen = _norm3(hi - lo)
        score = torch.where(wrong_side & torch.isfinite(dist), dist + pen,
                            dist)
    k = torch.argmin(score, dim=-1)
    qi = torch.arange(pts.shape[0], device=pts.device)
    return BdyLocateResult(cand[qi, k], lam[qi, k], dist[qi, k])


def locate_points(mesh: Mesh, pts, seeds=None, max_steps: int = 64,
                  fallback: bool = True) -> LocateResult:
    """Morton-seeded walk, then the exhaustive closest-element fallback
    for the queries it could not place. `mesh` must carry a fresh
    adjacency."""
    if seeds is None:
        seeds = morton_seeds(mesh, pts)
    res = walk_locate(mesh, pts, seeds, max_steps=max_steps)
    fail = torch.nonzero(~res.found).reshape(-1)
    if fallback and fail.numel():
        fb_tet, fb_bary = exhaustive_locate(mesh, pts[fail])
        tet, bary = res.tet.clone(), res.bary.clone()
        tet[fail] = fb_tet
        bary[fail] = fb_bary
        res = LocateResult(tet, bary, res.found, res.steps)
    return res
