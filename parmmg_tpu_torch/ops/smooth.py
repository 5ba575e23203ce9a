"""Batched vertex smoothing (relaxation toward the neighbour centroid).

Counterpart of `parmmg_tpu/ops/smooth.py` (`smooth_vertices`, full
sweep, the fixed freeze-round loop the JAX package runs off the TPU).
Interior vertices relax toward the centroid of their edge neighbours,
surface vertices tangentially toward their surface neighbours, feature
vertices along their feature edges; tets that would invert or degrade
(scored through the `quality_vol` kernel) and trias that would fold
freeze their vertices, with a global revert as the last safety net.

Frontier mode: with an `active` vertex mask only active vertices are
relaxed (an inactive vertex would repeat its last sub-threshold step),
and with no active movable vertex the sweep launches nothing (a host
decision where the JAX package takes a `lax.cond`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..core import tags
from ..core.mesh import Mesh
from . import common
from .analysis import _cross, _dot, _norm, surf_tria_mask, vertex_normals
from .common import scatter, take

_FEAT_BITS = tags.RIDGE | tags.REF | tags.NOM
_HARD = tags.REQUIRED | tags.CORNER | tags.PARBDY | tags.NOM | tags.OVERLAP
_COS_SURF = 0.70710678
# displacements under this fraction of the local metric size are
# suppressed (the vertex snaps back), so relaxation reaches a fixed point
MOVE_TOL = 5e-3


class SmoothStats(NamedTuple):
    nmoved: torch.Tensor
    nfrozen: torch.Tensor
    changed_v: torch.Tensor  # [PC] bool: moved beyond MOVE_TOL


def _local_h(met):
    """[PC] local metric size: h (iso), 1/sqrt(tr(M)/3) (aniso)."""
    if met.shape[1] == 1:
        return met[:, 0]
    tr = (met[:, 0] + met[:, 3] + met[:, 5]) / 3.0
    return torch.rsqrt(torch.clamp(tr, min=1e-30))


def smooth_vertices(mesh: Mesh, edges, emask, relax: float = 0.5,
                    rounds: int = 4, qfactor: float = 0.5,
                    nosurf: bool = False, active=None):
    """One smoothing sweep; returns (mesh, SmoothStats)."""
    pcap = mesh.pcap
    dev = mesh.device
    vert0 = mesh.vert
    dtype = vert0.dtype
    tet = mesh.tet.to(torch.int32).contiguous()

    vt = mesh.vtag
    hard = (vt & _HARD) != 0
    bdy_v = (vt & tags.BDY) != 0
    feat_v = (vt & _FEAT_BITS) != 0
    free_i = mesh.vmask & ~hard & ~bdy_v
    surf_v = mesh.vmask & ~hard & bdy_v & ~feat_v
    ridge_v = mesh.vmask & ~hard & bdy_v & feat_v
    if nosurf:
        surf_v = torch.zeros_like(surf_v)
        ridge_v = torch.zeros_like(ridge_v)
    if active is not None:
        free_i, surf_v, ridge_v = (free_i & active, surf_v & active,
                                   ridge_v & active)
    movable = free_i | surf_v | ridge_v
    if active is not None and not bool(movable.any()):
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return mesh, SmoothStats(
            nmoved=zero, nfrozen=zero,
            changed_v=torch.zeros(pcap, dtype=torch.bool, device=dev))

    # --- edge classes -----------------------------------------------------
    a, b = edges[:, 0], edges[:, 1]
    smask = surf_tria_mask(mesh)
    tri_keys = common.tria_edge_keys(mesh, smask)
    surf_e = common.sorted_membership(
        tri_keys, torch.where(emask[:, None], edges, -1), bound=pcap)
    feat = common.feature_edge_index(mesh, edges, emask)
    feat_tag = torch.where(feat >= 0, take(mesh.edtag, feat), 0)
    feat_e = (feat_tag & _FEAT_BITS) != 0

    # one centroid pass: each vertex class weighs its own edge subset
    def end_w(vid):
        return (emask & (take(free_i, vid) | (take(surf_v, vid) & surf_e)
                         | (take(ridge_v, vid) & feat_e))).to(dtype)

    wa, wb = end_w(a), end_w(b)
    acc = torch.zeros((pcap, 3), dtype=dtype, device=dev)
    acc = scatter(acc, a, take(vert0, b) * wa[:, None], op="add")
    acc = scatter(acc, b, take(vert0, a) * wb[:, None], op="add")
    cnt = torch.zeros(pcap, dtype=dtype, device=dev)
    cnt = scatter(cnt, a, wa, "add")
    cnt = scatter(cnt, b, wb, "add")
    cent = acc / torch.clamp(cnt, min=1.0)[:, None]

    d = cent - vert0
    # frontier mode reads normals only at the active surface vertices
    vn = vertex_normals(mesh, need=surf_v if active is not None else None)
    d_surf = d - _dot(d, vn)[:, None] * vn
    has_cnt = (cnt > 0)[:, None]
    disp = torch.where((free_i | ridge_v)[:, None] & has_cnt, d, 0.0)
    disp = torch.where(surf_v[:, None] & has_cnt, d_surf, disp)
    target = vert0 + relax * disp

    q_old, vol0 = kernels.quality_vol(vert0, mesh.met, tet)
    vol_floor = common.POS_VOL_FRAC * torch.abs(vol0)

    tri = mesh.tria

    def tria_normals_at(pos):
        p0, p1, p2 = (take(pos, tri[:, k]) for k in range(3))
        return _cross(p1 - p0, p2 - p0)

    r_old = tria_normals_at(vert0)
    nr_old = _norm(r_old)

    def bad_entities(pos):
        q_new, vol = kernels.quality_vol(pos.contiguous(), mesh.met, tet)
        bad_t = mesh.tmask & ((vol <= vol_floor) | (q_new < qfactor * q_old))
        r_new = tria_normals_at(pos)
        nr_new = _norm(r_new)
        dotn = _dot(r_old, r_new) / torch.clamp(nr_old * nr_new, min=1e-30)
        bad_f = smask & ((dotn < _COS_SURF)
                         | (nr_new < 1e-12 * torch.clamp(nr_old, min=1e-30)))
        return bad_t, bad_f

    frozen = ~movable
    for _ in range(rounds):
        pos = torch.where(frozen[:, None], vert0, target)
        bad_t, bad_f = bad_entities(pos)
        freeze_v = torch.zeros(pcap, dtype=torch.bool, device=dev)
        freeze_v = scatter(freeze_v, torch.where(bad_t[:, None], mesh.tet,
                                                 pcap).reshape(-1), True)
        freeze_v = scatter(freeze_v, torch.where(bad_f[:, None], tri,
                                                 pcap).reshape(-1), True)
        frozen = frozen | freeze_v

    pos = torch.where(frozen[:, None], vert0, target)
    h_loc = torch.clamp(_local_h(mesh.met), min=1e-30)
    small = _norm(pos - vert0) <= MOVE_TOL * h_loc
    pos = torch.where(small[:, None], vert0, pos)
    bad_t, bad_f = bad_entities(pos)
    still_bad = torch.any(bad_t) | torch.any(bad_f)
    pos = torch.where(still_bad, vert0, pos)

    moved = movable & ~frozen & ~still_bad & ~small & (cnt > 0)
    # frontier: only vertices that moved beyond MOVE_TOL re-enter the
    # next sweep's active set, so converging relaxation drains it
    chg = _norm(pos - vert0) > MOVE_TOL * h_loc
    return mesh.replace(vert=pos), SmoothStats(
        nmoved=moved.to(torch.int32).sum(),
        nfrozen=(movable & frozen).to(torch.int32).sum(),
        changed_v=chg & mesh.vmask,
    )
