"""Initial mesh distribution: split a centralized mesh into stacked
shards, derive the node communicator tables, number new vertices, and
merge the shards back into one mesh.

Counterpart of `parmmg_tpu/parallel/distribute.py` (`ShardComm`,
`split_mesh`, `rebuild_comm`, `assign_global_ids`, `merge_shards`).
`split_mesh` and `merge_shards` are host numpy, as there; the table
rebuild and the numbering run on the mesh's device.

A stacked mesh is a `Mesh` whose leaves carry a leading shard axis
[D, cap, ...] with uniform capacities across shards. `stack_meshes` and
`unstack_mesh` convert between it and a list of per-shard meshes (the
shards of `unstack_mesh` are views, not copies).

Communicator model: `comm_idx[s, r, k]` is the local vertex slot, in
shard s, of the k-th vertex shared between shards s and r, ordered by
global id so slot k names the same vertex on both sides (-1 pads).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..core import adjacency, tags
from ..core.mesh import FACE_VERTS, LEAVES, Mesh


@dataclasses.dataclass(frozen=True)
class ShardComm:
    """Node-communicator tables of a D-shard mesh."""

    comm_idx: torch.Tensor   # [D, D, I] local vertex slot of the k-th
    #                          vertex shared with the other shard, -1 pad
    counts: torch.Tensor     # [D, D] int32 shared vertices per pair
    l2g: torch.Tensor        # [D, PC] int32 global id per slot (-1 dead)
    owner: torch.Tensor      # [D, PC] bool: this shard owns the vertex
    #                          (the lowest shard that holds it)

    @property
    def nshard(self) -> int:
        return self.comm_idx.shape[0]

    @property
    def icap(self) -> int:
        return self.comm_idx.shape[2]


def stack_meshes(meshes) -> Mesh:
    """Per-shard meshes of equal capacities -> one stacked Mesh."""
    first = meshes[0]
    return first.replace(**{k: torch.stack([getattr(m, k) for m in meshes])
                            for k in LEAVES})


def unstack_mesh(stacked: Mesh) -> List[Mesh]:
    """Stacked [D, ...] Mesh -> list of per-shard Meshes (views)."""
    return [stacked.replace(**{k: getattr(stacked, k)[s] for k in LEAVES})
            for s in range(stacked.vert.shape[0])]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def split_mesh(mesh: Mesh, part: np.ndarray, nparts: int,
               headroom: float = 1.5, assume_adjacency: bool = False,
               build_shard_adjacency: bool = True) -> Tuple[Mesh, ShardComm]:
    """Split a Mesh into `nparts` shards per tet partition `part`.

    Returns (stacked Mesh, ShardComm) on the mesh's device. Vertices on
    inter-shard interfaces are tagged PARBDY in every shard that holds
    them (frozen); boundary trias follow the shard of their tet;
    interface faces become PARBDY|REQUIRED|NOSURF|BDY trias on both
    sides (an input tria on such a face keeps its ref and tags, with
    PARBDYBDY); feature edges go to every shard holding both ends."""
    if not assume_adjacency:
        mesh = adjacency.build_adjacency(mesh)
    part = np.asarray(part)
    h = {k: _np(getattr(mesh, k)) for k in LEAVES}
    tmask, adja, tet, vert = h["tmask"], h["adja"], h["tet"], h["vert"]
    tria, trmask, edge, edmask = h["tria"], h["trmask"], h["edge"], \
        h["edmask"]
    trref_g, trtag_g = h["trref"], h["trtag"]

    live_t = np.nonzero(tmask)[0]
    if (part[live_t] < 0).any() or (part[live_t] >= nparts).any():
        raise ValueError("partition must assign every valid tet to a shard")

    # --- interface vertices: shards per vertex -----------------------------
    npcap = vert.shape[0]
    pairs = np.unique(
        np.stack([tet[live_t].ravel(), np.repeat(part[live_t], 4)], axis=1),
        axis=0,
    )
    v_nshards = np.bincount(pairs[:, 0], minlength=npcap)

    # --- tria -> owning tet shard (boundary faces have a unique tet) -------
    fv = tet[:, FACE_VERTS].reshape(-1, 3)
    fkey = np.sort(fv, axis=1)
    ftet = np.repeat(np.arange(tet.shape[0]), 4)
    fvalid = np.repeat(tmask, 4)

    tria_live = np.nonzero(trmask)[0]
    tkey = np.sort(tria[tria_live], axis=1)

    vsel = np.nonzero(fvalid)[0]
    fk = fkey[vsel]
    allrows = np.concatenate([fk, tkey]) if len(tkey) else fk
    _, inv = np.unique(allrows, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    fid, qid = inv[: len(fk)], inv[len(fk):]
    nrows = inv.max() + 1 if len(inv) else 1
    face_tet = np.full(nrows, -1, np.int64)
    face_tet[fid] = ftet[vsel]
    face_tria = np.full(nrows, -1, np.int64)
    face_tria[qid] = tria_live
    tria_shard = np.full(tria.shape[0], -1)
    if len(tkey):
        hit = face_tet[qid] >= 0
        if not hit.all():
            bad = tria_live[~hit][:5]
            raise ValueError(f"boundary trias {bad} match no valid tet face")
        tria_shard[tria_live] = part[face_tet[qid]]

    # --- interface faces become PARBDY triangles in each side shard --------
    nb = adja // 4
    ifc_mask = (adja >= 0) & tmask[:, None]
    ifc_mask &= part[np.maximum(nb, 0)] != part[:, None]
    ifc_t, ifc_f = np.nonzero(ifc_mask)
    ifc_verts = tet[ifc_t[:, None], FACE_VERTS[ifc_f]]  # [K,3]
    ifc_shard = part[ifc_t]
    IFC_TAG = tags.PARBDY | tags.REQUIRED | tags.NOSURF | tags.BDY

    # an input tria on an interior face that becomes an interface keeps
    # its ref/tags on both sides (PARBDYBDY), with its own winding; NOSURF
    # marks the REQUIRED bit as split-added unless the user required it
    ifc_ref = np.zeros(len(ifc_verts), np.int64)
    ifc_tag = np.full(len(ifc_verts), IFC_TAG, np.int64)
    if len(tkey) and len(ifc_verts):
        pos = np.searchsorted(vsel, ifc_t * 4 + ifc_f)
        hit = face_tria[fid[pos]]
        m = hit >= 0
        ifc_ref[m] = trref_g[hit[m]]
        ifc_verts[m] = tria[hit[m]]
        user_req = (trtag_g[hit[m]] & tags.REQUIRED) != 0
        ifc_tag[m] = (
            trtag_g[hit[m]]
            | (tags.PARBDY | tags.PARBDYBDY | tags.REQUIRED | tags.BDY)
            | np.where(user_req, 0, tags.NOSURF)
        )
        tria_shard[hit[m]] = -1  # replicated via the interface list

    # --- per-shard extraction ---------------------------------------------
    shard_data = []
    for s in range(nparts):
        t_ids = live_t[part[live_t] == s]
        gids = np.unique(tet[t_ids])  # sorted: local order = gid order
        ltet = np.searchsorted(gids, tet[t_ids])
        f_ids = np.nonzero(tria_shard == s)[0]
        sel_ifc = ifc_shard == s
        ltria = np.concatenate([
            np.searchsorted(gids, tria[f_ids]).reshape(-1, 3),
            np.searchsorted(gids, ifc_verts[sel_ifc]).reshape(-1, 3),
        ])
        e_live = np.nonzero(edmask)[0]
        e_keep = e_live[np.isin(edge[e_live], gids).all(axis=1)]
        ledge = (np.searchsorted(gids, edge[e_keep]) if len(e_keep)
                 else np.zeros((0, 2), np.int64))
        # PARBDY: vertices seen by more than one shard
        lvtag = h["vtag"][gids].copy()
        par = v_nshards[gids] > 1
        lvtag[par] |= tags.PARBDY
        lvtag[par & ((lvtag & tags.BDY) != 0)] |= tags.PARBDYBDY
        shard_data.append(dict(
            gids=gids, verts=vert[gids], vrefs=h["vref"][gids], vtags=lvtag,
            tets=ltet, trefs=h["tref"][t_ids], trias=ltria,
            trrefs=np.concatenate([trref_g[f_ids], ifc_ref[sel_ifc]]),
            trtags=np.concatenate([trtag_g[f_ids], ifc_tag[sel_ifc]]),
            edges=ledge, edrefs=h["edref"][e_keep],
            edtags=h["edtag"][e_keep], met=h["met"][gids],
            ls=h["ls"][gids] if h["ls"].shape[1] else None,
            disp=h["disp"][gids] if h["disp"].shape[1] else None,
            fields=h["fields"][gids] if h["fields"].shape[1] else None,
        ))

    # --- uniform capacities ------------------------------------------------
    def cap(n):
        return max(8, int(np.ceil(n * headroom)))

    pcap = cap(max(len(d["gids"]) for d in shard_data))
    tcap = cap(max(len(d["tets"]) for d in shard_data))
    fcap = cap(max(max(len(d["trias"]), 1) for d in shard_data))
    ecap = cap(max(max(len(d["edges"]), 1) for d in shard_data))

    meshes = [
        Mesh.from_numpy(
            d["verts"], d["tets"], vrefs=d["vrefs"], vtags=d["vtags"],
            trefs=d["trefs"], trias=d["trias"], trrefs=d["trrefs"],
            trtags=d["trtags"], edges=d["edges"], edrefs=d["edrefs"],
            edtags=d["edtags"], met=d["met"] if mesh.met_set else None,
            ls=d["ls"], disp=d["disp"], fields=d["fields"],
            field_ncomp=mesh.field_ncomp, vglob=d["gids"], pcap=pcap,
            tcap=tcap, fcap=fcap, ecap=ecap, dtype=mesh.dtype,
            device=mesh.device,
        )
        for d in shard_data
    ]
    if build_shard_adjacency:
        meshes = [adjacency.build_adjacency(m) for m in meshes]
    stacked = stack_meshes(meshes)
    return stacked, rebuild_comm(stacked)


def _pow2_at_least(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


_GID_INF = 2**31 - 1


def _rebuild_comm_device(vglob, vmask, vtag, kv: int, icap: int):
    """Per-pair sorted-gid intersections into [D,D,icap] tables. `kv`
    bounds the per-shard interface list, `icap` the per-pair shared
    list; returns (comm_idx, counts, l2g, owner, largest pair list)."""
    D, PC = vglob.shape
    dev = vglob.device
    par = vmask & (vglob >= 0) & ((vtag & tags.PARBDY) != 0)
    key = torch.where(par, vglob, _GID_INF)
    order = torch.argsort(key, dim=1, stable=True)[:, :kv]      # [D,kv]
    gids = torch.gather(key, 1, order).contiguous()              # sorted
    valid = gids < _GID_INF

    # hit[s,r,k]: is gids[s,k] present in gids[r]?
    g_r = gids[None, :, :].expand(D, D, kv).contiguous()
    g_s = gids[:, None, :].expand(D, D, kv).contiguous()
    pos = torch.searchsorted(g_r, g_s).clamp(0, kv - 1)
    hit = valid[:, None, :] & (torch.gather(g_r, 2, pos) == g_s)
    eye = torch.eye(D, dtype=torch.bool, device=dev)
    hit = hit & ~eye[:, :, None]
    counts = hit.to(torch.int32).sum(dim=2)                      # [D,D]

    # pack each pair's hits (ascending gid on both sides) into icap slots
    rank = torch.cumsum(hit.to(torch.int64), dim=2) - 1
    tgt = torch.where(hit & (rank < icap), rank, icap)
    slots = order[:, None, :].expand(D, D, kv).to(torch.int32)
    comm_idx = torch.full((D, D, icap + 1), -1, dtype=torch.int32,
                          device=dev)
    comm_idx.scatter_(2, tgt, slots)
    comm_idx = comm_idx[:, :, :icap].contiguous()

    # owner = lowest shard holding the gid
    lower = torch.tril(torch.ones((D, D), dtype=torch.bool, device=dev),
                       diagonal=-1)                              # r < s
    held_lower = torch.any(hit & lower[:, :, None], dim=1)       # [D,kv]
    own_list = valid & ~held_lower
    owner = torch.cat([vmask, torch.zeros((D, 1), dtype=torch.bool,
                                          device=dev)], dim=1)
    owner.scatter_(1, torch.where(valid, order, PC), own_list)
    owner = owner[:, :PC].contiguous()
    l2g = torch.where(vmask, vglob, -1)
    return comm_idx, counts, l2g, owner, counts.max()


def rebuild_comm(stacked: Mesh, icap: int | None = None) -> ShardComm:
    """(Re-)derive the `ShardComm` node tables from `Mesh.vglob`: the
    shared list of each shard pair is the gid intersection of their
    PARBDY vertices, sorted by gid (the same k-order on both sides). The
    tables are sized to the largest pair list (a power of two) unless
    `icap` is given; a given `icap` below the need raises."""
    par_counts = (stacked.vmask & (stacked.vglob >= 0)
                  & ((stacked.vtag & tags.PARBDY) != 0)).sum(dim=1)
    PC = stacked.vglob.shape[1]
    kv = min(_pow2_at_least(max(int(par_counts.max()), 1)), PC)
    args = (stacked.vglob, stacked.vmask, stacked.vtag, kv)
    use_icap = kv if icap is None else icap
    comm_idx, counts, l2g, owner, need = _rebuild_comm_device(*args,
                                                              use_icap)
    need = int(need)
    if need > use_icap:
        if icap is not None:
            raise ValueError(f"icap {icap} < largest shared list {need}")
        use_icap = _pow2_at_least(need)
        comm_idx, counts, l2g, owner, _ = _rebuild_comm_device(*args,
                                                               use_icap)
    if icap is None:
        tight = _pow2_at_least(max(need, 1))
        if tight < use_icap:
            comm_idx, counts, l2g, owner, _ = _rebuild_comm_device(*args,
                                                                   tight)
    return ShardComm(comm_idx=comm_idx, counts=counts, l2g=l2g, owner=owner)


def assign_global_ids(stacked: Mesh) -> Mesh:
    """Give remeshing-created vertices (vglob == -1) fresh contiguous
    global ids: an exclusive scan of the per-shard new-vertex counts on
    top of the current largest id (new vertices are interior to their
    shard, since interfaces are frozen)."""
    vglob, vmask = stacked.vglob, stacked.vmask
    new = vmask & (vglob < 0)
    base = torch.where(vmask & (vglob >= 0), vglob, -1).max() + 1
    counts = new.to(torch.int64).sum(dim=1)
    offs = base + torch.cumsum(counts, 0) - counts
    rank = torch.cumsum(new.to(torch.int64), dim=1) - 1
    newid = (offs[:, None] + rank).to(torch.int32)
    return stacked.replace(vglob=torch.where(new, newid, vglob))


def merge_shards(stacked: Mesh, comm: ShardComm) -> Mesh:
    """Gather all shards into one centralized Mesh on the stacked mesh's
    device, deduplicating interface vertices by global id; the interface
    bookkeeping (PARBDY bits, synthetic interface trias, split-added
    REQUIRED) is dropped."""
    h = {k: _np(getattr(stacked, k)) for k in LEAVES}
    l2g = _np(comm.l2g)
    vmask_all = h["vmask"]
    if (vmask_all & (l2g < 0)).any():
        raise ValueError(
            "merge: live vertices without global ids — run "
            "assign_global_ids after remeshing"
        )
    # the gid space may have gaps (collapsed-away vertices): dense output
    # ids via the sorted set of live gids
    live_gids = np.unique(l2g[vmask_all])
    nglob = len(live_gids)
    fdt = h["vert"].dtype
    vert = np.zeros((nglob, 3), fdt)
    vref = np.zeros(nglob, np.int32)
    vtag = np.zeros(nglob, np.int32)
    sols = {k: np.zeros((nglob, h[k].shape[2]), fdt)
            for k in ("met", "ls", "disp", "fields")}
    seen = np.zeros(nglob, bool)
    tets, trefs, trias, trrefs, trtags = [], [], [], [], []
    edges, edrefs, edtags = [], [], []
    for s in range(vmask_all.shape[0]):
        vm = vmask_all[s]
        g = np.full(l2g.shape[1], -1, np.int64)
        g[vm] = np.searchsorted(live_gids, l2g[s][vm])
        gi = g[vm]
        vert[gi] = h["vert"][s][vm]
        vref[gi] = h["vref"][s][vm]
        vtag[gi] = h["vtag"][s][vm] & ~(
            tags.PARBDY | tags.PARBDYBDY | tags.OLDPARBDY)
        for k, a in sols.items():
            if a.shape[1]:
                a[gi] = h[k][s][vm]
        seen[gi] = True
        tm = h["tmask"][s]
        tets.append(g[h["tet"][s][tm]])
        trefs.append(h["tref"][s][tm])
        # synthetic interface trias are interior faces of the merged
        # mesh; PARBDYBDY trias are real boundary, kept and deduplicated
        trtag_s = h["trtag"][s]
        fm = h["trmask"][s] & ~tags.pure_interface_tria(trtag_s)
        tt = trtag_s[fm] & ~(tags.PARBDY | tags.PARBDYBDY)
        syn = (tt & tags.NOSURF) != 0
        tt = np.where(syn, tt & ~(tags.REQUIRED | tags.NOSURF), tt)
        trias.append(g[h["tria"][s][fm]])
        trrefs.append(h["trref"][s][fm])
        trtags.append(tt)
        em = h["edmask"][s]
        edges.append(g[h["edge"][s][em]])
        edrefs.append(h["edref"][s][em])
        edtags.append(h["edtag"][s][em])
    if not seen.all():
        raise ValueError("merge: some global vertex ids were never filled")
    trias_m, trrefs_m, trtags_m = (np.concatenate(trias),
                                   np.concatenate(trrefs),
                                   np.concatenate(trtags))
    if len(trias_m):
        _, uniq = np.unique(np.sort(trias_m, axis=1), axis=0,
                            return_index=True)
        trias_m, trrefs_m, trtags_m = (trias_m[uniq], trrefs_m[uniq],
                                       trtags_m[uniq])
    edges_m = np.concatenate(edges) if edges else np.zeros((0, 2), int)
    if len(edges_m):
        _, uniq = np.unique(np.sort(edges_m, axis=1), axis=0,
                            return_index=True)
        edges_m = edges_m[uniq]
        edrefs_m = np.concatenate(edrefs)[uniq]
        edtags_m = np.concatenate(edtags)[uniq]
    else:
        edrefs_m = edtags_m = np.zeros(0, int)
    return Mesh.from_numpy(
        vert, np.concatenate(tets), vrefs=vref, vtags=vtag,
        trefs=np.concatenate(trefs), trias=trias_m, trrefs=trrefs_m,
        trtags=trtags_m, edges=edges_m, edrefs=edrefs_m, edtags=edtags_m,
        met=sols["met"] if stacked.met_set else None,
        ls=sols["ls"] if sols["ls"].shape[1] else None,
        disp=sols["disp"] if sols["disp"].shape[1] else None,
        fields=sols["fields"] if sols["fields"].shape[1] else None,
        field_ncomp=stacked.field_ncomp, dtype=stacked.dtype,
        device=stacked.device,
    )
