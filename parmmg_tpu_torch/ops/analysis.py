"""Surface analysis: boundary, ridges, corners, normals, non-manifold.

Counterpart of the single-shard part of `parmmg_tpu/ops/analysis.py`
(`analyze` and the functions it calls). The surface is analyzed with one
sort of the tria-edge keys; normals are oriented by matching each tria
to its owner tet face; detected feature edges are appended to
`mesh.edge`. The cross-shard passes (`cross_shard_features`,
`cross_shard_singul`) are host numpy sort-merge joins over all shards'
interface rows keyed by global vertex ids, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import tags
from ..core.adjacency import build_adjacency
from ..core.mesh import FACE_VERTS, Mesh
from ..kernels.quality_k import _cross, _dot3 as _dot
from . import common
from .common import scatter, take

ANG_DEFAULT = 45.0


def _face_verts(mesh: Mesh):
    return mesh.tet[:, torch.as_tensor(FACE_VERTS, dtype=torch.int64,
                                       device=mesh.device)]   # [TC,4,3]


def mark_boundary(mesh: Mesh) -> Mesh:
    """OR BDY into vtag for vertices of valid trias and of tet faces with
    no neighbour (requires fresh adjacency)."""
    pcap = mesh.pcap
    bdy = torch.zeros(pcap, dtype=torch.bool, device=mesh.device)
    idx = torch.where(mesh.trmask[:, None], mesh.tria, pcap)
    bdy = scatter(bdy, idx.reshape(-1), True)
    open_face = (mesh.adja < 0) & mesh.tmask[:, None]
    idx2 = torch.where(open_face[..., None], _face_verts(mesh), pcap)
    bdy = scatter(bdy, idx2.reshape(-1), True)
    vtag = torch.where(bdy & mesh.vmask, mesh.vtag | tags.BDY, mesh.vtag)
    return mesh.replace(vtag=vtag)


def _sorted3(v):
    lo = v.min(dim=-1).values
    hi = v.max(dim=-1).values
    return torch.stack([lo, v.sum(dim=-1, dtype=v.dtype) - lo - hi, hi],
                       dim=-1)


def _missing_face_info(mesh: Mesh):
    """Open tet faces with no matching tria: (need [TC,4], count)."""
    open_face = (mesh.adja < 0) & mesh.tmask[:, None]
    fkeys = _sorted3(_face_verts(mesh)).reshape(-1, 3)
    fkeys = torch.where(open_face.reshape(-1)[:, None], fkeys, -1)
    trkeys = _sorted3(torch.where(mesh.trmask[:, None], mesh.tria, -1))
    have = common.sorted_membership(trkeys, fkeys,
                                    bound=mesh.pcap).reshape(-1, 4)
    need = open_face & ~have
    return need, need.to(torch.int32).sum()


def synthesize_boundary_trias(mesh: Mesh) -> Mesh:
    """Append a boundary tria for every open tet face that has none."""
    need, cnt = _missing_face_info(mesh)
    n_need = int(cnt)
    if n_need == 0:
        return mesh
    nf0 = int(mesh.ntria)
    if nf0 + n_need > mesh.fcap:
        mesh = mesh.with_capacity(fcap=int((nf0 + n_need) * 1.3) + 8)
        need, _ = _missing_face_info(mesh)
    return _append_trias(mesh, need)


def _append_trias(mesh: Mesh, need) -> Mesh:
    nf0 = mesh.ntria
    fcap = mesh.fcap
    fverts = _face_verts(mesh).reshape(-1, 3)
    flat = need.reshape(-1)
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    tgt = torch.where(flat, nf0 + rank, fcap)
    trefs = mesh.tref.repeat_interleave(4)
    return mesh.replace(
        tria=scatter(mesh.tria, tgt, fverts),
        trref=scatter(mesh.trref, tgt, trefs),
        trtag=scatter(mesh.trtag, tgt, tags.BDY),
        trmask=scatter(mesh.trmask, tgt, flat),
    )


def _tria_owner_match(mesh: Mesh, smask):
    """Owner tet faces of each tria: (fid1, fid2, cnt) into 4*TC slots."""
    fkeys = _sorted3(_face_verts(mesh)).reshape(-1, 3)
    fkeys = torch.where(mesh.tmask.repeat_interleave(4)[:, None], fkeys, -1)
    trkeys = _sorted3(torch.where(smask[:, None], mesh.tria, -1))
    return common.match_rows2(fkeys, trkeys, bound=mesh.pcap)


def mark_opnbdy(mesh: Mesh) -> Mesh:
    """Tag internal same-ref trias as open boundaries (-opnbdy)."""
    smask = surf_tria_mask(mesh)
    fid1, fid2, cnt = _tria_owner_match(mesh, smask)
    ref1 = take(mesh.tref, torch.clamp(fid1, min=0) // 4)
    ref2 = take(mesh.tref, torch.clamp(fid2, min=0) // 4)
    opn = smask & (cnt >= 2) & (ref1 == ref2)
    trtag = torch.where(opn, mesh.trtag | tags.OPNBDY | tags.BDY,
                        mesh.trtag)
    idx = torch.where(opn[:, None], mesh.tria, mesh.pcap)
    vb = scatter(torch.zeros(mesh.pcap, dtype=torch.bool,
                             device=mesh.device), idx.reshape(-1), True)
    vtag = torch.where(vb & mesh.vmask, mesh.vtag | tags.BDY, mesh.vtag)
    return mesh.replace(trtag=trtag, vtag=vtag)


def surf_tria_mask(mesh: Mesh):
    """Valid trias that are true surface (not NOSURF interface trias)."""
    return mesh.trmask & ((mesh.trtag & tags.NOSURF) == 0)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def tria_normals(mesh: Mesh):
    """Oriented unit normals and areas of boundary trias: (normal [FC,3],
    area [FC], ok [FC]). Boundary trias point away from their owner tet,
    material interfaces from the lower-ref side into the higher one."""
    smask = surf_tria_mask(mesh)
    p0 = take(mesh.vert, mesh.tria[:, 0])
    p1 = take(mesh.vert, mesh.tria[:, 1])
    p2 = take(mesh.vert, mesh.tria[:, 2])
    raw = _cross(p1 - p0, p2 - p0)
    fid1, fid2, cnt = _tria_owner_match(mesh, smask)
    f1 = torch.clamp(fid1, min=0).long()
    f2 = torch.clamp(fid2, min=0).long()
    t1, t2 = f1 // 4, f2 // 4
    ref1 = take(mesh.tref, t1)
    ref2 = take(mesh.tref, t2)
    internal = cnt >= 2
    same_ref = internal & (ref1 == ref2)
    use2 = internal & (ref2 < ref1)
    t_ref = torch.where(use2, t2, t1)
    f_ref = torch.where(use2, f2, f1) % 4
    opp = take(mesh.vert, take(mesh.tet, t_ref).gather(
        1, f_ref[:, None]).squeeze(1))
    opn = (mesh.trtag & tags.OPNBDY) != 0
    flip = (cnt > 0) & ~opn & (_dot(raw, p0 - opp) < 0)
    raw = torch.where(flip[:, None], -raw, raw)
    nrm = _norm(raw)
    ok = smask & (nrm > 0) & (~same_ref | opn)
    unit = raw / torch.clamp(nrm, min=1e-30)[:, None]
    return unit, 0.5 * nrm, ok


def vertex_normals(mesh: Mesh, need=None):
    """[PC,3] area-weighted unit vertex normals over surface trias (zero
    off the surface). `need` (frontier mode) restricts the trias."""
    unit, area, ok = tria_normals(mesh)
    pcap = mesh.pcap
    if need is not None:
        ok = ok & torch.any(take(need, mesh.tria), dim=1)
    w = torch.where(ok, area, 0.0)
    contrib = unit * w[:, None]
    acc = torch.zeros((pcap, 3), dtype=mesh.vert.dtype, device=mesh.device)
    idx = torch.where(ok[:, None], mesh.tria, pcap)
    for k in range(3):
        acc = common.scatter(acc, idx[:, k], contrib, op="add")
    n = _norm(acc)
    return acc / torch.clamp(n, min=1e-30)[:, None]


def _detect_feature_edges(mesh: Mesh, cos_ang: float):
    """Classify every unique surface edge from one sort of tria-edge
    keys: (first [3FC] bool, pairs [3FC,2], etag [3FC]). RIDGE for a
    sharp manifold pair, REF for a ref change, RIDGE|REF for an open
    border, NOM|REQUIRED for a non-manifold fan."""
    fcap = mesh.fcap
    dev = mesh.device
    unit, _, ok = tria_normals(mesh)
    t = mesh.tria
    pairs = torch.stack([t[:, [0, 1]], t[:, [1, 2]], t[:, [0, 2]]], dim=1)
    lo = torch.minimum(pairs[..., 0], pairs[..., 1]).reshape(-1)
    hi = torch.maximum(pairs[..., 0], pairs[..., 1]).reshape(-1)
    n3 = 3 * fcap
    dead = ~ok.repeat_interleave(3)
    order, newgrp, live_sorted, slo, shi = common.sorted_pair_groups(
        lo, hi, dead, mesh.pcap
    )
    cnt = common.seg_broadcast(live_sorted.to(torch.int32), newgrp, "add", 0)
    f = torch.zeros(1, dtype=torch.bool, device=dev)
    eq_next = torch.cat([~newgrp[1:], f])
    eq_prev = torch.cat([f, eq_next[:-1]])
    not_mid = ~(eq_next & eq_prev)
    pair2 = eq_next & not_mid & torch.roll(not_mid, -1) & (cnt == 2)
    partner_sorted = torch.where(
        pair2, torch.roll(order, -1),
        torch.where(torch.roll(pair2, 1) & (cnt == 2), torch.roll(order, 1),
                    -1),
    )
    tri_of = order // 3
    psafe = torch.clamp(partner_sorted, min=0)
    tri_partner = psafe // 3
    dot = _dot(take(unit, tri_of), take(unit, tri_partner))
    opn_t = (mesh.trtag & tags.OPNBDY) != 0
    both_opn = take(opn_t, tri_of) & take(opn_t, tri_partner)
    fwd = pairs[..., 0] < pairs[..., 1]                  # [FC,3]
    is02 = torch.tensor([[False, False, True]], device=dev)
    cyc = (fwd ^ is02).reshape(-1)
    same_dir = take(cyc, order) == take(cyc, psafe)
    dot = torch.where(both_opn & same_dir, -dot, dot)
    refdiff = take(mesh.trref, tri_of) != take(mesh.trref, tri_partner)
    has_partner = partner_sorted >= 0

    etag_sorted = torch.zeros(n3, dtype=torch.int32, device=dev)
    etag_sorted = torch.where(live_sorted & has_partner & (dot < cos_ang),
                              etag_sorted | tags.RIDGE, etag_sorted)
    etag_sorted = torch.where(live_sorted & has_partner & refdiff,
                              etag_sorted | tags.REF, etag_sorted)
    par_v = (mesh.vtag & tags.PARBDY) != 0
    slo_c = torch.clamp(slo, 0, mesh.pcap - 1)
    shi_c = torch.clamp(shi, 0, mesh.pcap - 1)
    par_edge = take(par_v, slo_c) & take(par_v, shi_c)
    etag_sorted = torch.where(live_sorted & (cnt == 1) & ~par_edge,
                              etag_sorted | tags.RIDGE | tags.REF,
                              etag_sorted)
    etag_sorted = torch.where(live_sorted & (cnt > 2) & ~par_edge,
                              etag_sorted | tags.NOM | tags.REQUIRED,
                              etag_sorted)
    etag_g = common.seg_broadcast_or(
        etag_sorted, newgrp,
        (tags.RIDGE, tags.REF, tags.NOM, tags.REQUIRED),
    )
    first = torch.zeros(n3, dtype=torch.bool, device=dev)
    first[order] = newgrp & live_sorted
    etag = torch.zeros(n3, dtype=torch.int32, device=dev)
    etag[order] = etag_g
    prs = torch.zeros((n3, 2), dtype=torch.int32, device=dev)
    prs[order] = torch.stack([slo, shi], 1).to(torch.int32)
    return first, prs, etag


def _merge_info(mesh: Mesh, first, prs, etag):
    """Detected feature edges that are new vs already stored: (new_sel,
    n_new, match into mesh.edge or -1)."""
    elo = torch.minimum(mesh.edge[:, 0], mesh.edge[:, 1])
    ehi = torch.maximum(mesh.edge[:, 0], mesh.edge[:, 1])
    ekeys = torch.stack([torch.where(mesh.edmask, elo, -1),
                         torch.where(mesh.edmask, ehi, -1)], dim=1)
    feat = first & (etag != 0)
    q = torch.where(feat[:, None], prs, -1)
    match = common.match_rows(ekeys, q, bound=mesh.pcap)
    new_sel = feat & (match < 0)
    return new_sel, new_sel.to(torch.int32).sum(), match


def _apply_features(mesh: Mesh, first, prs, etag, new_sel, match) -> Mesh:
    """OR detected tags into matched stored edges, append the new ones,
    and propagate feature bits to their endpoints."""
    ecap = mesh.ecap
    ned0 = mesh.nedge
    midx = torch.where((match >= 0) & first, match, ecap)
    add = torch.zeros(ecap, dtype=torch.int32, device=mesh.device)
    for bit in (tags.RIDGE, tags.REF, tags.NOM, tags.REQUIRED):
        hasbit = scatter(torch.zeros(ecap, dtype=torch.bool,
                                     device=mesh.device),
                         midx, (etag & bit) != 0, "max")
        add = add | torch.where(hasbit, bit, 0).to(torch.int32)
    edtag = mesh.edtag | add
    rank = torch.cumsum(new_sel.to(torch.int64), 0) - 1
    tgt = torch.where(new_sel, ned0 + rank, ecap)
    mesh = mesh.replace(
        edge=scatter(mesh.edge, tgt, prs),
        edtag=scatter(edtag, tgt, etag),
        edref=scatter(mesh.edref, tgt, 0),
        edmask=scatter(mesh.edmask, tgt, new_sel),
    )
    return _tag_feature_vertices(mesh)


def _tag_feature_vertices(mesh: Mesh) -> Mesh:
    """Endpoints of feature edges inherit the feature bits (and BDY)."""
    pcap = mesh.pcap
    vadd = torch.zeros(pcap, dtype=torch.int32, device=mesh.device)
    live = mesh.edmask
    for bit in (tags.RIDGE, tags.REF, tags.NOM, tags.REQUIRED):
        hasbit = torch.zeros(pcap, dtype=torch.bool, device=mesh.device)
        src = live & ((mesh.edtag & bit) != 0)
        for k in range(2):
            idx = torch.where(live, mesh.edge[:, k], pcap)
            hasbit = scatter(hasbit, idx, src, "max")
        vadd = vadd | torch.where(hasbit, bit, 0).to(torch.int32)
    vadd = torch.where(vadd != 0, vadd | tags.BDY, vadd)
    return mesh.replace(
        vtag=mesh.vtag | torch.where(mesh.vmask, vadd, 0).to(torch.int32))


def classify_corners(mesh: Mesh, cos_ang: float) -> Mesh:
    """Corner classification (`PMMG_singul` semantics): a vertex with
    other than two feature edges, or two edges bending sharply, is
    CORNER."""
    pcap = mesh.pcap
    live = mesh.edmask & (
        (mesh.edtag & (tags.RIDGE | tags.REF | tags.NOM)) != 0)
    a, b = mesh.edge[:, 0], mesh.edge[:, 1]
    deg = torch.zeros(pcap, dtype=torch.int32, device=mesh.device)
    deg = scatter(deg, torch.where(live, a, pcap), 1, "add")
    deg = scatter(deg, torch.where(live, b, pcap), 1, "add")
    d = take(mesh.vert, b) - take(mesh.vert, a)
    u = d / torch.clamp(_norm(d), min=1e-30)[:, None]
    w = live.to(mesh.vert.dtype)[:, None]
    acc = torch.zeros((pcap, 3), dtype=mesh.vert.dtype, device=mesh.device)
    acc = scatter(acc, torch.where(live, a, pcap), u * w, "add")
    acc = scatter(acc, torch.where(live, b, pcap), -u * w, "add")
    bend2 = _dot(acc, acc)
    sharp = bend2 > (2.0 - 2.0 * cos_ang)
    corner = ((deg == 1) | (deg >= 3) | ((deg == 2) & sharp)) & mesh.vmask
    return mesh.replace(
        vtag=torch.where(corner, mesh.vtag | tags.CORNER, mesh.vtag))


def detect_features(mesh: Mesh, ang: float = ANG_DEFAULT) -> Mesh:
    """Dihedral ridge + ref-change + non-manifold detection, feature-edge
    storage, vertex tagging and corner classification."""
    cos_ang = math.cos(math.radians(ang))
    first, prs, etag = _detect_feature_edges(mesh, cos_ang)
    new_sel, n_new, match = _merge_info(mesh, first, prs, etag)
    n_new = int(n_new)
    ned0 = int(mesh.nedge)
    if ned0 + n_new > mesh.ecap:
        mesh = mesh.with_capacity(ecap=int((ned0 + n_new) * 1.3) + 8)
    mesh = _apply_features(mesh, first, prs, etag, new_sel, match)
    return classify_corners(mesh, cos_ang)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def cross_shard_features(shards: list, ang: float = ANG_DEFAULT) -> list:
    """Feature detection for surface edges split by a shard interface
    (the `PMMG_setdhd` role): each side of an interface-crossing surface
    edge sees only one of its two boundary trias, so the per-shard
    detection skips it; here the two halves meet across the shards,
    keyed by global vertex ids (a host sort-merge join), and the
    singularity classification reruns on the global counts
    (`cross_shard_singul`). Takes and returns a list of per-shard
    meshes already through `analyze()`."""
    cos_ang = math.cos(math.radians(ang))
    # (gid pair, normal, ref, shard, local slots) rows of every shard
    blk = []
    for s, m in enumerate(shards):
        unit, _, ok = tria_normals(m)
        unit, ok = _np(unit), _np(ok)
        tria, trref = _np(m.tria), _np(m.trref)
        vt, vg = _np(m.vtag), _np(m.vglob)
        par = ((vt & tags.PARBDY) != 0) & (vg >= 0)
        for e0, e1 in ((0, 1), (1, 2), (0, 2)):
            a, b = tria[:, e0], tria[:, e1]
            idx = np.nonzero(ok & par[a] & par[b])[0]
            if not len(idx):
                continue
            la, lb = a[idx].astype(np.int64), b[idx].astype(np.int64)
            ga, gb = vg[la].astype(np.int64), vg[lb].astype(np.int64)
            swap = ga > gb
            blk.append((
                np.where(swap, gb, ga), np.where(swap, ga, gb),
                unit[idx], trref[idx].astype(np.int64),
                np.full(len(idx), s, np.int64),
                np.where(swap, lb, la), np.where(swap, la, lb),
            ))
    if not blk:
        return cross_shard_singul(shards, cos_ang)
    glo, ghi, nrm, ref, shd, llo, lhi = (
        np.concatenate([b[k] for b in blk]) for k in range(7))

    # group the rows by gid-pair key
    order = np.lexsort((ghi, glo))
    glo, ghi, nrm, ref, shd, llo, lhi = (
        x[order] for x in (glo, ghi, nrm, ref, shd, llo, lhi))
    newgrp = np.concatenate(
        [[True], (glo[1:] != glo[:-1]) | (ghi[1:] != ghi[:-1])])
    starts = np.nonzero(newgrp)[0]
    gid = np.cumsum(newgrp) - 1
    counts = np.diff(np.append(starts, len(glo)))
    # cross-shard groups only: same-shard pairs had the local detection
    cross = (np.maximum.reduceat(shd, starts)
             > np.minimum.reduceat(shd, starts))
    etag_g = np.zeros(len(starts), np.int64)
    two = counts == 2
    i0 = starts[two]
    if len(i0):
        dot = np.einsum("ij,ij->i", nrm[i0], nrm[i0 + 1])
        etag_g[two] = (np.where(dot < cos_ang, tags.RIDGE, 0)
                       | np.where(ref[i0] != ref[i0 + 1], tags.REF, 0))
    etag_g[counts > 2] = tags.NOM | tags.REQUIRED  # cross-shard NOM fan
    etag_g[~cross] = 0

    row_etag = etag_g[gid]
    emit = row_etag != 0
    out = []
    for s, m in enumerate(shards):
        sel = emit & (shd == s)
        if sel.any():
            pairs = np.stack([llo[sel], lhi[sel]], axis=1)
            m = _merge_host_edges(m, pairs, row_etag[sel])
            m = classify_corners(m, cos_ang)
        out.append(m)
    return cross_shard_singul(out, cos_ang)


def cross_shard_singul(shards: list, cos_ang: float) -> list:
    """Singularity classification of interface points with global
    feature counts (the `PMMG_singul` role): a feature line crossing an
    interface looks like a line end on both sides, so the feature-edge
    degree and direction sum of every interface vertex are reduced over
    all shards (interface-interface edges, replicated per side, counted
    once by their global key) and the corner rule rerun on them.
    Input-REQUIRED corners are never unset."""
    feature = tags.RIDGE | tags.REF | tags.NOM
    gids_all, dirs_all = [], []
    seen_pp = np.empty(0, np.int64)
    for m in shards:
        ed = _np(m.edge)
        live = _np(m.edmask) & ((_np(m.edtag) & feature) != 0)
        if not live.any():
            continue
        e = ed[live]
        vt, vg, v = _np(m.vtag), _np(m.vglob), _np(m.vert)
        a, b = e[:, 0], e[:, 1]
        d = v[b] - v[a]
        u = d / np.maximum(np.linalg.norm(d, axis=1), 1e-30)[:, None]
        par_a = ((vt[a] & tags.PARBDY) != 0) & (vg[a] >= 0)
        par_b = ((vt[b] & tags.PARBDY) != 0) & (vg[b] >= 0)
        both = par_a & par_b
        # replicated interface edges count once by their global key
        if both.any():
            ga, gb = vg[a[both]], vg[b[both]]
            glo, ghi = np.minimum(ga, gb), np.maximum(ga, gb)
            keys = glo.astype(np.int64) * (2**31) + ghi
            _, first = np.unique(keys, return_index=True)
            fresh = np.zeros(len(keys), bool)
            fresh[first] = True
            fresh &= ~np.isin(keys, seen_pp)
            seen_pp = np.concatenate([seen_pp, keys[fresh]])
            ub = u[both][fresh]
            gids_all.append(vg[a[both]][fresh])
            dirs_all.append(ub)
            gids_all.append(vg[b[both]][fresh])
            dirs_all.append(-ub)
        only_a = par_a & ~both
        only_b = par_b & ~both
        if only_a.any():
            gids_all.append(vg[a[only_a]])
            dirs_all.append(u[only_a])
        if only_b.any():
            gids_all.append(vg[b[only_b]])
            dirs_all.append(-u[only_b])

    if not gids_all:
        return shards
    gids = np.concatenate(gids_all)
    dirs = np.concatenate(dirs_all)
    ug, inv = np.unique(gids, return_inverse=True)
    inv = inv.reshape(-1)
    deg = np.bincount(inv, minlength=len(ug))
    acc = np.zeros((len(ug), 3))
    np.add.at(acc, inv, dirs)
    bend2 = np.sum(acc * acc, axis=1)
    sharp = bend2 > (2.0 - 2.0 * cos_ang)
    corner_g = (deg == 1) | (deg >= 3) | ((deg == 2) & sharp)
    gmax = int(ug.max()) + 1
    is_corner = np.zeros(gmax, bool)
    is_corner[ug] = corner_g
    has_feat = np.zeros(gmax, bool)
    has_feat[ug] = True

    out = []
    for m in shards:
        vt = _np(m.vtag).copy()
        vg = _np(m.vglob)
        sel = (((vt & tags.PARBDY) != 0) & (vg >= 0) & (vg < gmax)
               & _np(m.vmask))
        gsel = np.clip(vg, 0, gmax - 1)
        want = sel & is_corner[gsel]
        # clear the locally guessed corners of interface feature vertices
        # (never user-required ones), then set the agreed ones
        clear = sel & has_feat[gsel] & ~want & ((vt & tags.REQUIRED) == 0)
        vt[clear] &= ~tags.CORNER
        vt[want] |= tags.CORNER | tags.BDY
        out.append(m.replace(vtag=torch.as_tensor(vt, device=m.device)))
    return out


def _merge_host_edges(mesh: Mesh, pairs, etags) -> Mesh:
    """OR tags into the matching stored feature edges and append the
    missing ones, then re-propagate the vertex tags (the host variant of
    `_apply_features` for the cross-shard pass): a sort-merge join on
    canonical lo * pcap + hi keys."""
    edge = _np(mesh.edge)
    edmask = _np(mesh.edmask).copy()
    edtag = _np(mesh.edtag).copy()
    edref = _np(mesh.edref)

    P = np.int64(mesh.pcap)
    lo = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    hi = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    key = lo * P + hi
    # dedup the incoming pairs, OR-combining their tags
    order = np.argsort(key, kind="stable")
    ks, ts = key[order], np.asarray(etags, np.int64)[order]
    first = np.concatenate([[True], ks[1:] != ks[:-1]])
    starts = np.nonzero(first)[0]
    ukey = ks[starts]
    utag = np.bitwise_or.reduceat(ts, starts)

    live = np.nonzero(edmask)[0]
    ekey = (np.minimum(edge[live, 0], edge[live, 1]).astype(np.int64) * P
            + np.maximum(edge[live, 0], edge[live, 1]))
    eorder = np.argsort(ekey)
    if len(ekey):
        pos = np.clip(np.searchsorted(ekey[eorder], ukey), 0, len(ekey) - 1)
        hit = ekey[eorder[pos]] == ukey
        edtag[live[eorder[pos[hit]]]] |= utag[hit].astype(edtag.dtype)
    else:
        hit = np.zeros(len(ukey), bool)

    n_add = int((~hit).sum())
    ned = int(edmask.sum())
    if ned + n_add > mesh.ecap:
        mesh = mesh.with_capacity(ecap=int((ned + n_add) * 1.3) + 8)
        e2 = _np(mesh.edtag).copy()
        e2[: len(edtag)] = edtag
        edmask, edtag = _np(mesh.edmask).copy(), e2
        edge = _np(mesh.edge)
        edref = _np(mesh.edref)
    edge = edge.copy()
    edref = edref.copy()
    if n_add:
        slots = np.nonzero(~edmask)[0][:n_add]
        akey = ukey[~hit]
        edge[slots, 0] = akey // P
        edge[slots, 1] = akey % P
        edtag[slots] = utag[~hit]
        edref[slots] = 0
        edmask[slots] = True
    dev = mesh.device
    mesh = mesh.replace(edge=torch.as_tensor(edge, device=dev),
                        edtag=torch.as_tensor(edtag, device=dev),
                        edref=torch.as_tensor(edref, device=dev),
                        edmask=torch.as_tensor(edmask, device=dev))
    return _tag_feature_vertices(mesh)


def analyze(mesh: Mesh, ang: float | None = ANG_DEFAULT,
            features: bool = True, opnbdy: bool = False) -> Mesh:
    """Entry analysis (`MMG3D_analys` role): adjacency, boundary
    completion + marking, and unless `ang is None` ridge/corner
    detection."""
    mesh = build_adjacency(mesh)
    mesh = synthesize_boundary_trias(mesh)
    if opnbdy:
        mesh = mark_opnbdy(mesh)
    mesh = mark_boundary(mesh)
    if features and ang is not None:
        mesh = detect_features(mesh, ang)
    return mesh
