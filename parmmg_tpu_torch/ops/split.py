"""Batched edge split: refine every metric-long edge in parallel.

Counterpart of `parmmg_tpu/ops/split.py` (`split_long_edges`, full-table
sweep). A maximal independent set of long edges (at most one split edge
per tet, priority = metric length) is selected per sweep and every
incident tet/tria/feature edge is split 1->2 in one vectorized update.
Plain surface edges get the curvature-corrected midpoint unless an
incident child would fall below the positivity floor — checked by the
`split_midpoint` kernel.

Frontier mode: with an `active` vertex mask (the one-ring closure of the
previous sweep's changes) only long edges near the frontier are
candidates, and when there is none the sweep launches nothing (a host
decision where the JAX package takes a `lax.cond`). `active=None` is the
full-table sweep.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from ..core import metric as metric_mod
from ..core import tags
from ..core.mesh import Mesh
from . import common
from .analysis import _dot, surf_tria_mask, vertex_normals
from .common import scatter, take


class SplitStats(NamedTuple):
    nsplit: torch.Tensor    # edges split this sweep
    ncand: torch.Tensor     # long-edge candidates before selection
    capped: torch.Tensor    # bool: capacity limited the sweep
    changed_v: torch.Tensor  # [PC] bool: vertices whose 1-ring changed


# tag bits a new mid-edge vertex inherits from a surface/feature edge
_INHERIT = tags.BDY | tags.RIDGE | tags.REF | tags.REQUIRED

_TRI_PAIRS = ((0, 1), (1, 2), (0, 2))


def _i32(t):
    return t.to(torch.int32).contiguous()


def split_long_edges(mesh: Mesh, edges, emask, t2e,
                     llong: float = float(metric_mod.LLONG),
                     nosurf: bool = False, active=None):
    """One split sweep on a compacted mesh; returns (mesh, SplitStats).
    Adjacency is left stale."""
    ecap = edges.shape[0]
    tcap, pcap, fcap = mesh.tcap, mesh.pcap, mesh.fcap
    dev = mesh.device
    np0, ne0, nf0, ned0 = mesh.npoin, mesh.ntet, mesh.ntria, mesh.nedge

    a, b = edges[:, 0], edges[:, 1]
    pa, pb = take(mesh.vert, a), take(mesh.vert, b)
    l = metric_mod.edge_length(pa, pb, take(mesh.met, a), take(mesh.met, b))
    pre = emask & (l > llong)
    if active is not None:
        # an inactive long edge met the same arena last sweep and lost
        pre = pre & (take(active, a) | take(active, b))
        if not bool(pre.any()):
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            return mesh, SplitStats(
                nsplit=zero, ncand=zero,
                capped=torch.zeros((), dtype=torch.bool, device=dev),
                changed_v=torch.zeros(pcap, dtype=torch.bool, device=dev))

    # one sort-merge maps every tria edge to its unique-edge slot
    edge_keys = torch.where(emask[:, None], edges, -1)
    tri_keys = common.tria_edge_keys(mesh)
    eid3 = common.match_rows(edge_keys, tri_keys,
                             bound=pcap).reshape(fcap, 3)

    def mark_edges(tri_mask):
        tgt = torch.where(tri_mask[:, None] & (eid3 >= 0), eid3, ecap)
        return scatter(torch.zeros(ecap, dtype=torch.bool, device=dev),
                       tgt.reshape(-1), True)

    surf = mark_edges(mesh.trmask)
    feat = common.feature_edge_index(mesh, edges, emask)
    feat_tag = torch.where(feat >= 0, take(mesh.edtag, feat), 0)
    in_req_tri = mark_edges(
        mesh.trmask & ((mesh.trtag & tags.REQUIRED) != 0))
    frozen = (
        ((take(mesh.vtag, a) & tags.PARBDY) != 0)
        & ((take(mesh.vtag, b) & tags.PARBDY) != 0)
    ) | ((feat_tag & tags.REQUIRED) != 0) | in_req_tri
    if nosurf:
        frozen = frozen | surf
    cand = pre & ~frozen
    ncand = cand.to(torch.int32).sum()

    # --- independent-set selection: arena = incident tets ---------------
    live_e = (t2e >= 0) & mesh.tmask[:, None]             # [TC,6]
    safe_t2e = torch.where(live_e, t2e, 0).long()

    def scatter_arena(vals):
        v6 = torch.where(live_e, vals[safe_t2e], -math.inf)
        return v6.max(dim=1).values

    def gather_arena(av):
        tgt = torch.where(live_e, t2e, ecap)
        out = torch.full((ecap,), -math.inf, dtype=av.dtype, device=dev)
        return scatter(out, tgt.reshape(-1),
                       av[:, None].expand(tcap, 6).reshape(-1), "max")

    win = common.rank_winners(l, cand, scatter_arena, gather_arena)

    # --- capacity capping -----------------------------------------------
    inc_t = scatter(torch.zeros(ecap, dtype=torch.int64, device=dev),
                    safe_t2e.reshape(-1), live_e.reshape(-1).long(), "add")
    wi = win.long()
    rank_v = torch.cumsum(wi, 0) - 1
    used_t = torch.cumsum(wi * inc_t, 0)
    used_f = torch.cumsum(wi * surf.long() * 2, 0)
    used_e = torch.cumsum(wi * (feat >= 0).long(), 0)
    fits = (
        (np0 + rank_v + 1 <= pcap)
        & (ne0 + used_t <= tcap)
        & (nf0 + used_f <= fcap)
        & (ned0 + used_e <= mesh.ecap)
    )
    capped = torch.any(win & ~fits)
    win = win & fits
    rank_v = torch.cumsum(win.long(), 0) - 1
    nsplit = win.to(torch.int32).sum()
    vnew = torch.where(win, np0 + rank_v, -1).to(torch.int32)

    # per-tet winner mapping (midpoint validation + split)
    w6 = torch.where(live_e, win[safe_t2e], False)
    has = torch.any(w6, dim=1) & mesh.tmask
    k = torch.argmax(w6.to(torch.uint8), dim=1)
    e_of_t = safe_t2e.gather(1, k[:, None])[:, 0]
    ev = common.edge_verts_t(dev)
    li, lj = ev[k, 0], ev[k, 1]

    # --- new vertex position --------------------------------------------
    mid = 0.5 * (pa + pb)
    if not nosurf:
        need_v = None
        if active is not None:
            # normals are read only at candidate endpoints, whose rows
            # come out exact under `need`
            need_v = torch.zeros(pcap, dtype=torch.bool, device=dev)
            need_v = scatter(need_v, torch.where(pre, a, pcap), True)
            need_v = scatter(need_v, torch.where(pre, b, pcap), True)
        vn = vertex_normals(mesh, need=need_v)
        surf_real = mark_edges(surf_tria_mask(mesh) & mesh.trmask)
        na_, nb_ = take(vn, a), take(vn, b)
        has_n = (_dot(na_, na_) > 0.5) & (_dot(nb_, nb_) > 0.5)
        featv = (
            (take(mesh.vtag, a) | take(mesh.vtag, b))
            & (tags.RIDGE | tags.REF | tags.CORNER | tags.NOM | tags.PARBDY)
        ) != 0
        plain = surf_real & has_n & ~featv & (feat < 0)
        e_vec = pb - pa
        corr = (_dot(e_vec, nb_)[:, None] * nb_
                - _dot(e_vec, na_)[:, None] * na_) / 8.0
        mid_c = mid + corr
        # both child volumes of every incident tet vs the parent floor
        newp = mid_c[e_of_t].contiguous()
        okt = kernels.split_midpoint(mesh.vert, _i32(mesh.tet), newp,
                                     _i32(li), _i32(lj))
        bad_off = scatter(torch.zeros(ecap, dtype=torch.bool, device=dev),
                          torch.where(has & ~okt, e_of_t, ecap), True)
        mid = torch.where((plain & ~bad_off)[:, None], mid_c, mid)
    half = torch.full((ecap, 2), 0.5, dtype=mesh.dtype, device=dev)
    mmid = metric_mod.interp_metric(
        torch.stack([take(mesh.met, a), take(mesh.met, b)], dim=-2), half)
    new_tag = torch.where(surf, tags.BDY, 0) | (feat_tag & _INHERIT)
    new_ref = torch.where(feat >= 0, take(mesh.edref, feat), 0)

    tgt_v = common.unique_oob(win, vnew, pcap)

    def vavg(x):
        return 0.5 * (take(x, a) + take(x, b))

    out = dict(
        vert=scatter(mesh.vert, tgt_v, mid),
        met=scatter(mesh.met, tgt_v, mmid),
        ls=scatter(mesh.ls, tgt_v, vavg(mesh.ls)),
        disp=scatter(mesh.disp, tgt_v, vavg(mesh.disp)),
        fields=scatter(mesh.fields, tgt_v, vavg(mesh.fields)),
        vtag=scatter(mesh.vtag, tgt_v, new_tag),
        vref=scatter(mesh.vref, tgt_v, new_ref),
        vmask=scatter(mesh.vmask, tgt_v, True),
    )

    # --- split tets -----------------------------------------------------
    nv_of_t = vnew[e_of_t]
    slot4 = torch.arange(4, device=dev)[None, :]
    tet = mesh.tet
    # child A in place: vertex lj -> newv; child B appended: li -> newv
    tetA = torch.where((slot4 == lj[:, None]) & has[:, None],
                       nv_of_t[:, None], tet)
    tetB = torch.where(slot4 == li[:, None], nv_of_t[:, None], tet)
    app_rank = torch.cumsum(has.long(), 0) - 1
    tgt_t = common.unique_oob(has, ne0 + app_rank, tcap)
    out.update(
        tet=scatter(tetA, tgt_t, tetB),
        tref=scatter(mesh.tref, tgt_t, mesh.tref),
        tmask=scatter(mesh.tmask, tgt_t, has),
    )

    # --- split trias ----------------------------------------------------
    w3 = (eid3 >= 0) & win[torch.clamp(eid3, min=0).long()] \
        & mesh.trmask[:, None]
    fhas = torch.any(w3, dim=1)
    fk = torch.argmax(w3.to(torch.uint8), dim=1)
    tp = torch.as_tensor(_TRI_PAIRS, dtype=torch.int64, device=dev)
    fu, fv = tp[fk, 0], tp[fk, 1]
    fe = torch.clamp(eid3.gather(1, fk[:, None])[:, 0], min=0).long()
    fnv = vnew[fe]
    slot3 = torch.arange(3, device=dev)[None, :]
    triA = torch.where((slot3 == fv[:, None]) & fhas[:, None],
                       fnv[:, None], mesh.tria)
    triB = torch.where(slot3 == fu[:, None], fnv[:, None], mesh.tria)
    frank = torch.cumsum(fhas.long(), 0) - 1
    tgt_f = common.unique_oob(fhas, nf0 + frank, fcap)
    out.update(
        tria=scatter(triA, tgt_f, triB),
        trref=scatter(mesh.trref, tgt_f, mesh.trref),
        trtag=scatter(mesh.trtag, tgt_f, mesh.trtag),
        trmask=scatter(mesh.trmask, tgt_f, fhas),
    )

    # --- split feature edges: (r0,r1) -> (r0,newv) + appended (newv,r1) -
    ehas = win & (feat >= 0)
    fidx = torch.where(ehas, feat, mesh.ecap)
    r1 = take(mesh.edge[:, 1], torch.clamp(feat, min=0))
    col1 = scatter(mesh.edge[:, 1].contiguous(), fidx, vnew)
    edge_arr = torch.stack([mesh.edge[:, 0], col1], dim=1)
    erank = torch.cumsum(ehas.long(), 0) - 1
    tgt_e = common.unique_oob(ehas, ned0 + erank, mesh.ecap)
    edge_arr = scatter(edge_arr, tgt_e, torch.stack([vnew, r1], 1))
    out.update(
        edge=edge_arr,
        edref=scatter(mesh.edref, tgt_e,
                      torch.where(feat >= 0, take(mesh.edref, feat), 0)),
        edtag=scatter(mesh.edtag, tgt_e, feat_tag),
        edmask=scatter(mesh.edmask, tgt_e, ehas),
    )
    # frontier: the new midpoints plus every vertex of a split tet
    chg = scatter(torch.zeros(pcap, dtype=torch.bool, device=dev), tgt_v,
                  True)
    chg = scatter(chg, torch.where(has[:, None], mesh.tet,
                                   pcap).reshape(-1), True)
    return mesh.replace(**out), SplitStats(nsplit=nsplit, ncand=ncand,
                                           capped=capped, changed_v=chg)
