"""Metric and field interpolation from a background (old) mesh.

Counterpart of `parmmg_tpu/ops/interp.py`: every valid vertex of the new
mesh is located in the old one (`ops.locate`) and its metric, level-set,
displacement and user fields are interpolated with P1 barycentric
weights — harmonic in h for iso sizes, log-Euclidean for tensors. BDY
vertices take the boundary-triangulation path; REQUIRED vertices keep
their values.

Shards (a list of per-shard meshes of uniform capacities) are
interpolated shard by shard from their own snapshot, as the vmapped JAX
program does, but the walk runs over all shards at once (each shard's
tables stacked and offset into one flat table) and the volume pull is
one `interp_bary` launch over all shards.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List

import torch

from .. import kernels
from ..core import metric as metric_mod, tags
from ..core.mesh import Mesh
from . import locate
from .analysis import surf_tria_mask, vertex_normals
from .common import take


def take_rows(a, idx):
    """Per-shard `take`: a [D,N,...] gathered at idx [D,Q] -> [D,Q,...],
    with JAX's gather convention within each shard."""
    n = a.shape[1]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


def _lin(bary, a, vids):
    """P1 combination of the vertex rows `a` [P,c] at corners `vids`
    [...,K] with weights `bary` [...,K], summed left to right."""
    if a.shape[-1] == 0:
        return a.new_zeros(tuple(vids.shape[:-1]) + (0,))
    av = take(a, vids) if a.dim() == 2 else take_rows(a, vids)
    s = bary[..., 0, None] * av[..., 0, :]
    for k in range(1, vids.shape[-1]):
        s = s + bary[..., k, None] * av[..., k, :]
    return s


def interp_at(old: Mesh, tet_idx, bary):
    """(met, ls, disp, fields) of the old mesh at located points:
    tet_idx [Q] containing tet slots, bary [Q,4]."""
    vids = take(old.tet, tet_idx)
    met = metric_mod.interp_metric(take(old.met, vids), bary)
    return (met, _lin(bary, old.ls, vids), _lin(bary, old.disp, vids),
            _lin(bary, old.fields, vids))


def interp_at_points(old: Mesh, tet_idx, pts):
    """The fused pull at walk-located points (`kernels.interp_bary`):
    the clamped weights recomputed from the located tet and the query
    point (the walk's own final expression) and the metric in the same
    pass; ls/disp/fields ride the returned weights. For a stacked `old`
    (tet_idx [D,Q], pts [D,Q,3]) all shards go in one launch."""
    stacked = old.vert.dim() == 3
    vids = (take_rows(old.tet, tet_idx) if stacked
            else take(old.tet, tet_idx)).to(torch.int32).contiguous()
    bary, met = kernels.interp_bary(old.vert.contiguous(),
                                    old.met.contiguous(), vids,
                                    pts.contiguous())
    return (met, _lin(bary, old.ls, vids), _lin(bary, old.disp, vids),
            _lin(bary, old.fields, vids))


def interp_at_tria(old: Mesh, tria_idx, bary):
    """(met, ls, disp, fields) at points located on boundary trias (the
    3-node path)."""
    vids = take(old.tria, tria_idx)
    met = metric_mod.interp_metric(take(old.met, vids), bary)
    return (met, _lin(bary, old.ls, vids), _lin(bary, old.disp, vids),
            _lin(bary, old.fields, vids))


def _check_families(new: Mesh, old: Mesh):
    for name in ("met", "ls", "disp", "fields"):
        cn, co = getattr(new, name).shape[-1], getattr(old, name).shape[-1]
        if cn != co:
            raise ValueError(
                f"solution family mismatch: new.{name} has {cn} components, "
                f"old.{name} has {co} — the meshes must carry the same "
                "metric/sol types"
            )


def _on_bdy(new: Mesh, smask):
    """New vertices that take the surface path: BDY, not on a parallel
    interface (their nearest true-surface tria can be far), and only
    where the old mesh has surface trias at all."""
    return (((new.vtag & tags.BDY) != 0) & ((new.vtag & tags.PARBDY) == 0)
            & torch.any(smask))


def _overlay(new: Mesh, old: Mesh, pulled, surface: bool,
             cos_wedge: float) -> Mesh:
    """Apply the volume pull `pulled` = (met, ls, disp, fields) to `new`:
    overlay the surface path for BDY vertices, keep REQUIRED and dead
    slots."""
    met_q, ls_q, disp_q, f_q = pulled
    if surface:
        smask = surf_tria_mask(old)
        # query normals from the new surface keep a query near a ridge
        # on its own side of the feature
        bres = locate.bdy_locate(old, smask, new.vert,
                                 normals=vertex_normals(new),
                                 cos_wedge=cos_wedge)
        on_bdy = _on_bdy(new, smask)[:, None]
        surf = interp_at_tria(old, bres.tria, bres.bary)

        def pick(qv, sv):
            if qv.shape[1] == 0:
                return qv
            return torch.where(on_bdy, sv.to(qv.dtype), qv)

        met_q, ls_q, disp_q, f_q = (pick(q, s) for q, s in
                                    zip((met_q, ls_q, disp_q, f_q), surf))

    keep = (~new.vmask) | ((new.vtag & tags.REQUIRED) != 0)

    def sel(cur, q):
        if cur.shape[1] == 0:
            return cur
        return torch.where(keep[:, None], cur, q.to(cur.dtype))

    return new.replace(
        met=sel(new.met, met_q), ls=sel(new.ls, ls_q),
        disp=sel(new.disp, disp_q), fields=sel(new.fields, f_q),
        met_set=old.met_set,
    )


def _apply_interp(new: Mesh, old: Mesh, res, surface: bool,
                  cos_wedge: float = locate._COS_WEDGE, pts=None) -> Mesh:
    """Pull values at the located tets (through `interp_bary` when the
    query points `pts` are given), overlay the surface path for BDY
    vertices, respect REQUIRED."""
    pulled = (interp_at(old, res.tet, res.bary) if pts is None
              else interp_at_points(old, res.tet, pts))
    return _overlay(new, old, pulled, surface, cos_wedge)


def interp_metrics_and_fields(new: Mesh, old: Mesh, max_steps: int = 64,
                              surface: bool = True,
                              cos_wedge: float = locate._COS_WEDGE):
    """Locate every valid new vertex in `old` (fresh adjacency needed)
    and pull met/ls/disp/fields. Returns (mesh, volume LocateResult)."""
    _check_families(new, old)
    res = locate.locate_points(old, new.vert, max_steps=max_steps)
    return _apply_interp(new, old, res, surface, cos_wedge,
                         pts=new.vert), res


def _stacked_tables(olds: List[Mesh]):
    """The leaves the walk and the pull read, stacked over the shards
    ([D,cap,...])."""
    return SimpleNamespace(**{
        k: torch.stack([getattr(o, k) for o in olds])
        for k in ("vert", "tet", "adja", "met", "ls", "disp", "fields")})


def _interp_all_shards(news: List[Mesh], olds: List[Mesh], max_steps: int,
                       surface: bool, cos_wedge: float):
    """Walk-locate and interpolate every shard of `news` in its own
    shard of the snapshot `olds`. Returns (shards, found [D,PC])."""
    old = _stacked_tables(olds)
    d, tc, pco = old.tet.shape[0], old.tet.shape[1], old.vert.shape[1]
    dev = old.vert.device
    shard = torch.arange(d, device=dev)
    # dead slots aim at a live vertex (slot 0 of a compacted mesh), so
    # their walks end at once; their values are discarded
    pts = torch.stack([torch.where(n.vmask[:, None], n.vert, n.vert[:1])
                       for n in news])
    seeds = torch.stack([locate.morton_seeds(o, pts[s])
                         for s, o in enumerate(olds)])
    # one walk over all shards: shard s's tets, vertices and face codes
    # offset into flat tables (a walk never leaves its shard)
    tet_f = (old.tet.to(torch.int64) + (shard * pco)[:, None, None])
    adja = old.adja.to(torch.int64)
    adja_f = torch.where(adja >= 0, adja + (shard * 4 * tc)[:, None, None],
                         adja)
    res = locate.walk_tables(
        old.vert.reshape(-1, 3), tet_f.reshape(-1, 4), adja_f.reshape(-1, 4),
        pts.reshape(-1, 3), (seeds + (shard * tc)[:, None]).reshape(-1),
        max_steps=max_steps)
    tet_local = res.tet.to(torch.int64).reshape(d, -1) - (shard * tc)[:, None]
    pulled = interp_at_points(old, tet_local, pts)
    out = [_overlay(n, o, tuple(p[s] for p in pulled), surface, cos_wedge)
           for s, (n, o) in enumerate(zip(news, olds))]
    return out, res.found.reshape(d, -1)


def interp_stacked(news: List[Mesh], olds: List[Mesh], max_steps: int = 64,
                   surface: bool = True,
                   cos_wedge: float = locate._COS_WEDGE) -> List[Mesh]:
    """Interpolation of every shard of `news` from its snapshot in
    `olds`, with a host rescue (exhaustive closest-element search) only
    for the vertices the walk could not place and the surface path did
    not cover."""
    for n, o in zip(news, olds):
        _check_families(n, o)
    out, found = _interp_all_shards(news, olds, max_steps, surface,
                                    cos_wedge)
    need = ~found & torch.stack([n.vmask for n in news])
    if surface:
        # vertices the surface path interpolated keep the nearest-tria
        # value: the volume rescue must not replace it
        need = need & ~torch.stack([_on_bdy(n, surf_tria_mask(o))
                                    for n, o in zip(news, olds)])
    if not bool(need.any()):
        return out
    fixed = []
    for s, (n, o) in enumerate(zip(out, olds)):
        fail = torch.nonzero(need[s]).reshape(-1)
        if not fail.numel():
            fixed.append(n)
            continue
        fb_tet, fb_bary = locate.exhaustive_locate(o, n.vert[fail])
        pulled = interp_at(o, fb_tet, fb_bary)
        keep = ((n.vtag[fail] & tags.REQUIRED) != 0)[:, None]

        def patch(cur, q):
            if cur.shape[1] == 0:
                return cur
            cur = cur.clone()
            cur[fail] = torch.where(keep, cur[fail], q.to(cur.dtype))
            return cur

        fixed.append(n.replace(
            met=patch(n.met, pulled[0]), ls=patch(n.ls, pulled[1]),
            disp=patch(n.disp, pulled[2]), fields=patch(n.fields, pulled[3]),
        ))
    return fixed
