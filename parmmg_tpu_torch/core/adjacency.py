"""Tet-tet adjacency and unique-edge extraction by sort-based matching.

Counterpart of `parmmg_tpu/core/adjacency.py`: the full rebuilds and
the frontier sweeps' incremental `update_adjacency` and
`merge_unique_edges`. Faces/edges are canonicalized, sorted with stable
sorts and matched between equal neighbours.
"""

from __future__ import annotations

import torch

from .mesh import EDGE_VERTS, FACE_VERTS, Mesh

_BIG = 2**30


def _sort3(a, b, c):
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    mid = a + b + c - lo - hi
    return lo, mid, hi


def build_adjacency(mesh: Mesh) -> Mesh:
    """Fill `mesh.adja`: adja[t,f] = 4*t2+f2 for the face glued to (t,f),
    -1 for boundary faces; faces shared by 3+ tets stay unmatched."""
    from ..ops import common as _common

    tc = mesh.tcap
    dev = mesh.device
    fv = mesh.tet[:, torch.as_tensor(FACE_VERTS, dtype=torch.int64,
                                     device=dev)]            # [TC,4,3]
    a, b, c = _sort3(fv[..., 0], fv[..., 1], fv[..., 2])
    slot = torch.arange(tc * 4, dtype=torch.int64, device=dev).reshape(tc, 4)
    dead = ~mesh.tmask[:, None]
    # dead slots: a sentinel first column and a unique second one, so
    # they never match
    a = torch.where(dead, _BIG, a.to(torch.int64)).reshape(-1)
    b = torch.where(dead, slot, b.to(torch.int64)).reshape(-1)
    c = torch.where(dead, 0, c.to(torch.int64)).reshape(-1)
    order, partner = _pair_faces(a, b, c)
    adja_flat = torch.full((tc * 4,), -1, dtype=torch.int32, device=dev)
    adja_flat[order] = partner.to(torch.int32)
    return mesh.replace(adja=adja_flat.reshape(tc, 4))


def _pair_faces(a, b, c):
    """Sort face keys (a, b, c) (int64, b and c below 2^31) stably and
    pair the runs of exactly two equal faces. Returns (order, partner):
    partner[i] is the sorted position i's partner row or -1."""
    from ..ops import common as _common

    # (b, c) < 2^31 each: one packed int64 secondary key
    order = _common.lexsort(((b << 31) | c, a))
    sa, sb, sc = a[order], b[order], c[order]
    eq_next = (sa[:-1] == sa[1:]) & (sb[:-1] == sb[1:]) & (sc[:-1] == sc[1:])
    f = torch.zeros(1, dtype=torch.bool, device=a.device)
    eq_next = torch.cat([eq_next, f])
    eq_prev = torch.cat([f, eq_next[:-1]])
    # pair only runs of exactly 2 equal faces; longer runs are invalid
    not_mid = ~(eq_next & eq_prev)
    pair2 = eq_next & not_mid & torch.roll(not_mid, -1)
    partner = torch.where(
        pair2, torch.roll(order, -1),
        torch.where(torch.roll(pair2, 1), torch.roll(order, 1), -1),
    )
    return order, partner


def unique_edges(mesh: Mesh, ecap: int):
    """Unique undirected edges of the valid tets: (edges [ecap,2] int32,
    emask [ecap] bool, tet2edge [TC,6] int32 (-1 on dead tets or dropped
    edges), n_unique 0-d int32 = the true count). Edges beyond `ecap`
    are dropped; callers check n_unique and retry with a larger cap."""
    from ..ops import common as _common

    tc = mesh.tcap
    dev = mesh.device
    ev = mesh.tet[:, torch.as_tensor(EDGE_VERTS, dtype=torch.int64,
                                     device=dev)]             # [TC,6,2]
    lo = torch.minimum(ev[..., 0], ev[..., 1])
    hi = torch.maximum(ev[..., 0], ev[..., 1])
    dead = (~mesh.tmask[:, None]).expand(tc, 6)
    order, newgrp, live_sorted, slo, shi = _common.sorted_pair_groups(
        lo.reshape(-1), hi.reshape(-1), dead.reshape(-1), mesh.pcap
    )
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    first = newgrp & live_sorted
    tgt = _common.unique_oob(first & (gid < ecap), gid, ecap)
    edges = torch.zeros((ecap, 2), dtype=torch.int32, device=dev)
    edges = _common.scatter(edges, tgt, torch.stack([slo, shi], 1))
    emask = _common.scatter(torch.zeros(ecap, dtype=torch.bool, device=dev),
                            tgt, True)
    t2e_flat = torch.full((tc * 6,), -1, dtype=torch.int32, device=dev)
    t2e_flat[order] = torch.where(live_sorted & (gid < ecap), gid,
                                  -1).to(torch.int32)
    n_unique = first.to(torch.int32).sum()
    return edges, emask, t2e_flat.reshape(tc, 6), n_unique


def boundary_faces(mesh: Mesh):
    """Mask [TC,4] of faces with no neighbour (requires fresh adjacency)."""
    return (mesh.adja < 0) & mesh.tmask[:, None]


# ---------------------------------------------------------------------------
# incremental rebuilds of the frontier sweeps
#
# Contract: the table was built on the SAME vertex/tet numbering (no
# compaction since), and `changed_v` marks every vertex of every tet row
# created, deleted or rewritten since (the operators' `changed_v`
# guarantees it). A face or edge whose pairing or membership could have
# changed then has all its vertices in `changed_v`, so only those rows
# are recomputed, in a stream compacted to K rows, and merged into the
# old table. More than K hot rows fall back to the full rebuild, so the
# result is always exact. Each fallback decision is one host read.
# ---------------------------------------------------------------------------


def _compact_stream(hot, K: int):
    """Row ids of the first K rows where `hot` holds, -1 after them."""
    from ..ops import common as _common

    rank = torch.cumsum(hot.to(torch.int64), 0) - 1
    tgt = _common.unique_oob(hot & (rank < K), rank, K)
    ids = torch.arange(hot.shape[0], dtype=torch.int64, device=hot.device)
    return _common.scatter(torch.full((K,), -1, dtype=torch.int64,
                                      device=hot.device), tgt, ids)


def update_adjacency(mesh: Mesh, changed_v, K: int) -> Mesh:
    """Refresh `mesh.adja` for a frontier of changed vertices: only the
    faces whose 3 vertices are all in `changed_v` are re-matched, in a
    K-row stream; more than K such faces -> `build_adjacency`."""
    from ..ops import common as _common

    tc = mesh.tcap
    dev = mesh.device
    fv = mesh.tet[:, torch.as_tensor(FACE_VERTS, dtype=torch.int64,
                                     device=dev)]            # [TC,4,3]
    hot = (_common.take(changed_v, fv).all(dim=-1)
           & mesh.tmask[:, None]).reshape(-1)
    if int(hot.to(torch.int32).sum()) > K:
        return build_adjacency(mesh)
    a, b, c = _sort3(fv[..., 0], fv[..., 1], fv[..., 2])
    slot = _compact_stream(hot, K)
    valid = slot >= 0
    src = torch.clamp(slot, min=0)
    kidx = torch.arange(K, dtype=torch.int64, device=dev)
    ka = torch.where(valid, a.reshape(-1)[src].to(torch.int64), _BIG)
    kb = torch.where(valid, b.reshape(-1)[src].to(torch.int64), kidx)
    kc = torch.where(valid, c.reshape(-1)[src].to(torch.int64), kidx)
    order, partner_pos = _pair_faces(ka, kb, kc)
    gslot = slot[order]                           # global face slots
    # partner_pos holds stream rows; map them to global face slots
    partner = torch.where(partner_pos >= 0,
                          slot[torch.clamp(partner_pos, min=0)], -1)
    # every hot face gets its new pairing (or -1: now a boundary face);
    # cold faces keep theirs
    adja_flat = _common.scatter(
        mesh.adja.reshape(-1).contiguous(),
        _common.unique_oob(gslot >= 0, gslot, tc * 4), partner)
    adja = torch.where(mesh.tmask[:, None], adja_flat.reshape(tc, 4), -1)
    return mesh.replace(adja=adja.to(torch.int32))


def merge_unique_edges(mesh: Mesh, changed_v, edges, emask, t2e, n_unique,
                       K: int):
    """Incremental merge of a `unique_edges` table after topology deltas
    with stable numbering (the contract above): hot tets (all 4 vertices
    changed, live) have their 6 edges recomputed in a K-row stream and
    matched against the live table; an old slot stays alive iff a live
    tet still references it (cold rows through their `t2e`, hot rows
    through the fresh matches), the others are tombstoned; unmatched hot
    pairs are deduplicated and take the free slots in order. Falls back
    to the full `unique_edges` when the hot stream overflows K or the
    worst-case fresh count could overflow the table. Returns (edges,
    emask, t2e, n_unique) with `n_unique` the live edge count."""
    from ..ops import common as _common

    tc = mesh.tcap
    dev = mesh.device
    ecap = edges.shape[0]
    hot_t = _common.take(changed_v, mesh.tet).all(dim=-1) & mesh.tmask
    n_hot = int(hot_t.to(torch.int32).sum())
    if n_hot > K or int(n_unique) + 6 * n_hot > ecap:
        e, em, t2, nu = unique_edges(mesh, ecap)
        return e, em, t2, nu.to(torch.int32)

    # dead tets lose their rows; cold live rows are authoritative
    cold = mesh.tmask & ~hot_t
    t2e_base = torch.where(mesh.tmask[:, None], t2e, -1)
    cold_idx = torch.where(cold[:, None] & (t2e >= 0), t2e, ecap)
    cnt = _common.scatter(torch.zeros(ecap, dtype=torch.int32, device=dev),
                          cold_idx.reshape(-1), 1, "add")
    # K-compacted hot stream: each hot tet's 6 edges
    tslot = _compact_stream(hot_t, K)
    valid = tslot >= 0
    ev = mesh.tet[torch.clamp(tslot, min=0)][:, torch.as_tensor(
        EDGE_VERTS, dtype=torch.int64, device=dev)]          # [K,6,2]
    lo = torch.minimum(ev[..., 0], ev[..., 1]).reshape(-1)
    hi = torch.maximum(ev[..., 0], ev[..., 1]).reshape(-1)
    live = valid[:, None].expand(K, 6).reshape(-1)
    # match against the live old slots; a matched slot survives
    q = torch.stack([torch.where(live, lo, -1),
                     torch.where(live, hi, -1)], dim=1)
    old_keys = torch.where(emask[:, None], edges, -1)
    eid = _common.match_rows(old_keys, q, bound=mesh.pcap).to(torch.int64)
    matched = live & (eid >= 0)
    cnt = _common.scatter(cnt, torch.where(matched, eid, ecap), 1, "add")
    alive_old = emask & (cnt > 0)
    # fresh pairs, deduplicated among themselves (live groups first)
    fresh = live & (eid < 0)
    order, newgrp, live_s, slo, shi = _common.sorted_pair_groups(
        lo, hi, ~fresh, mesh.pcap)
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    first = newgrp & live_s
    # slot_of[j]: the j-th free slot (tombstoned now or never used)
    free = ~alive_old
    free_pos = torch.cumsum(free.to(torch.int64), 0) - 1
    slot_of = _common.scatter(
        torch.full((ecap,), ecap, dtype=torch.int64, device=dev),
        _common.unique_oob(free, free_pos, ecap),
        torch.arange(ecap, dtype=torch.int64, device=dev))
    rep_slot = slot_of[torch.clamp(gid, 0, ecap - 1)]
    rep_tgt = _common.unique_oob(first & (rep_slot < ecap), rep_slot, ecap)
    edges_out = _common.scatter(edges, rep_tgt,
                                torch.stack([slo, shi], dim=1))
    emask_out = _common.scatter(alive_old, rep_tgt, True)
    # per-row final slot: matched -> its old slot, fresh -> its group's
    gid_rows = torch.zeros(K * 6, dtype=torch.int64, device=dev)
    gid_rows[order] = gid
    eid_final = torch.where(fresh, slot_of[torch.clamp(gid_rows, 0,
                                                       ecap - 1)], eid)
    eid_final = torch.where(live & (eid_final >= 0) & (eid_final < ecap),
                            eid_final, -1).to(torch.int32)
    t2e_out = _common.scatter(t2e_base, _common.unique_oob(valid, tslot, tc),
                              eid_final.reshape(K, 6))
    return (edges_out, emask_out, t2e_out,
            emask_out.to(torch.int32).sum())
