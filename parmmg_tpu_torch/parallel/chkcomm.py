"""Communicator invariant checks on a stacked mesh.

Counterpart of `parmmg_tpu/parallel/chkcomm.py` (the role of the
reference's `src/chkcomm_pmmg.c`): every shard's side of each shared
vertex list is compared with the peer's copies (coordinates, global ids,
list lengths, live slots), and the replicated interface trias and
interface feature edges are matched across all shards by their sorted
global-id keys (each pure interface tria on exactly two shards; equal
barycenters, midpoints and feature bits across copies). The JAX package
runs these under `shard_map`; here the shards share one stacked tensor,
so its `all_gather` is a reshape of the shard axis, `pmax` / `psum` are
reductions over it and the `all_to_all` of the list lengths is a
transpose. `assert_comm_ok` raises `AssertionError` on any violation.
"""

from __future__ import annotations

import torch

from ..core import tags
from ..core.mesh import Mesh
from ..ops import common
from ..ops.locate import _mean_rows
from .comm import halo_exchange
from .distribute import ShardComm


def check_node_comm(stacked: Mesh, comm: ShardComm) -> dict:
    """Geometric and topological node-communicator invariants: dict(
    max_coord_err, gid_mismatch, count_mismatch, valid_mismatch) as host
    scalars; all zero (or small) when the tables are coherent."""
    ci = comm.comm_idx.long()
    valid = ci >= 0                                          # [D,D,I]
    safe = ci.clamp(min=0)
    d = ci.shape[0]
    shard = torch.arange(d, device=ci.device)[:, None, None].expand(ci.shape)
    recv = halo_exchange(stacked.vert, ci)                   # [D,D,I,3]
    local = stacked.vert[shard, safe]
    err = torch.where(valid[..., None], (recv - local).abs(), 0.0)
    recv_g = halo_exchange(comm.l2g, ci)
    local_g = comm.l2g[shard, safe]
    gid_mm = (valid & (recv_g != local_g)).sum()
    my_counts = valid.to(torch.int32).sum(dim=2)             # [D,D]
    count_mm = (my_counts != my_counts.T).sum()
    valid_mm = (valid & ~stacked.vmask[shard, safe]).sum()
    out = torch.stack([err.max().to(torch.float64), gid_mm.double(),
                       count_mm.double(), valid_mm.double()]).tolist()
    return dict(max_coord_err=out[0], gid_mismatch=int(out[1]),
                count_mismatch=int(out[2]), valid_mismatch=int(out[3]))


def _spread(vals, valid, newgrp, order):
    """Largest per-group coordinate spread of `vals` over the valid
    members (rows sorted by `order`, groups from `newgrp`). Returns
    (spread, group of each sorted row, valid of each sorted row)."""
    n = vals.shape[0]
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    sval = valid[order]
    sv = vals[order]
    hi = common.scatter(torch.full((n, 3), -torch.inf, dtype=sv.dtype,
                                   device=sv.device), gid,
                        torch.where(sval[:, None], sv, -torch.inf), "max")
    lo = common.scatter(torch.full((n, 3), torch.inf, dtype=sv.dtype,
                                   device=sv.device), gid,
                        torch.where(sval[:, None], sv, torch.inf), "min")
    d = torch.where(torch.isfinite(hi) & torch.isfinite(lo), hi - lo, 0.0)
    return d.max(), gid, sval


def check_face_edge_comm(stacked: Mesh, comm: ShardComm) -> dict:
    """Geometric face and edge communicator invariants over all shards:
    dict(max_face_bc_err, face_count_bad, max_edge_mid_err,
    edge_tag_mismatch)."""
    l2g = comm.l2g.long()
    d, pc = l2g.shape
    shard = torch.arange(d, device=l2g.device)
    # interface trias, keyed by sorted global ids
    pp = tags.pure_interface_tria(stacked.trtag) & stacked.trmask   # [D,FC]
    tria = stacked.tria.long()
    g3 = torch.sort(l2g[shard[:, None, None], tria], dim=2).values
    g3 = torch.where(pp[..., None], g3, -1).reshape(-1, 3)
    bc = _mean_rows(stacked.vert[shard[:, None, None], tria].reshape(
        -1, 3, 3))
    V = pp.reshape(-1)
    order, newgrp = common._row_order_groups(g3, ~V, None)
    face_err, gid, sval = _spread(bc, V, newgrp, order)
    n = g3.shape[0]
    cnt = common.scatter(torch.zeros(n, dtype=torch.int32,
                                     device=l2g.device), gid,
                         sval.to(torch.int32), "add")
    face_bad = (sval & (cnt[gid] != 2)).sum()

    # interface feature edges, keyed by sorted global-id pairs
    par_v = (stacked.vtag & tags.PARBDY) != 0
    edge = stacked.edge.long()
    ec = edge.clamp(0, pc - 1)
    e_ok = (stacked.edmask & par_v[shard[:, None], ec[..., 0]]
            & par_v[shard[:, None], ec[..., 1]])
    g2 = torch.sort(l2g[shard[:, None, None], edge], dim=2).values
    g2 = torch.where(e_ok[..., None], g2, -1).reshape(-1, 2)
    mid = _mean_rows(stacked.vert[shard[:, None, None], edge].reshape(
        -1, 2, 3))
    W = e_ok.reshape(-1)
    T = stacked.edtag.reshape(-1)
    order_e, newgrp_e = common._row_order_groups(g2, ~W, None)
    edge_err, gid_e, sval_e = _spread(mid, W, newgrp_e, order_e)
    ne = g2.shape[0]
    # geometric feature bits must agree across copies (the parallel
    # bookkeeping bits may differ per shard)
    st = T[order_e] & (tags.RIDGE | tags.REF)
    big = 2**30
    thi = common.scatter(torch.zeros(ne, dtype=torch.int32,
                                     device=l2g.device), gid_e,
                         torch.where(sval_e, st, 0), "max")
    tlo = common.scatter(torch.full((ne,), big, dtype=torch.int32,
                                    device=l2g.device), gid_e,
                         torch.where(sval_e, st, big), "min")
    th, tl = thi[gid_e], tlo[gid_e]
    tag_mm = (sval_e & (th != torch.where(tl == big, th, tl))).sum()
    out = torch.stack([face_err.double(), face_bad.double(),
                       edge_err.double(), tag_mm.double()]).tolist()
    return dict(max_face_bc_err=out[0], face_count_bad=int(out[1]),
                max_edge_mid_err=out[2], edge_tag_mismatch=int(out[3]))


def assert_comm_ok(stacked: Mesh, comm: ShardComm,
                   tol: float = 1e-12) -> dict:
    """Both checks; raises `AssertionError` with the report unless every
    count is zero and every coordinate error within `tol`."""
    rep = check_node_comm(stacked, comm)
    rep.update(check_face_edge_comm(stacked, comm))
    ok = (rep["max_coord_err"] <= tol and rep["gid_mismatch"] == 0
          and rep["count_mismatch"] == 0 and rep["valid_mismatch"] == 0
          and rep["max_face_bc_err"] <= tol and rep["face_count_bad"] == 0
          and rep["max_edge_mid_err"] <= tol
          and rep["edge_tag_mismatch"] == 0)
    if not ok:
        raise AssertionError(f"communicator check failed: {rep}")
    return rep
