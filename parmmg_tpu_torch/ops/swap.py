"""Batched topology swaps: 3-2 edge swaps and 2-3 face swaps.

Counterpart of `parmmg_tpu/ops/swap.py` (`swap_32`, `swap_23`,
full-table sweeps, the off-TPU rebuild after the duplicate check). A
swap is applied only when the worst quality of the new configuration
beats the old one by GAIN; candidates are compacted worst-first, scored
through the `quality_vol` kernel, and selected as an independent set
with the affected tets as arena.

Frontier mode: with an `active` vertex mask only edges/faces near the
frontier pass the cheap prefilter, and with none the sweep launches
nothing past it (a host decision where the JAX package takes a
`lax.cond`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from ..core import tags
from ..core.mesh import FACE_VERTS, Mesh
from . import common
from .common import scatter, take

GAIN = 1.02          # required relative quality improvement
QTHRESH = 0.5        # only try to improve tets worse than this


class SwapStats(NamedTuple):
    nswap32: torch.Tensor
    nswap23: torch.Tensor
    changed_v: torch.Tensor  # [PC] bool: vertices whose 1-ring changed


def _i32(t):
    return t.to(torch.int32).contiguous()


def _oriented(t4, vert):
    """Swap the first two vertices of candidate tets with negative
    volume."""
    sw = common.vol_of(vert, t4) < 0
    v0 = torch.where(sw, t4[:, 1], t4[:, 0])
    v1 = torch.where(sw, t4[:, 0], t4[:, 1])
    return torch.stack([v0, v1, t4[:, 2], t4[:, 3]], dim=1)


def _mark_changed(pcap, win, cols):
    """[PC] bool from the vertex columns of winning candidates."""
    chg = torch.zeros(pcap, dtype=torch.bool, device=win.device)
    for c in cols:
        chg = scatter(chg, torch.where(win, c, pcap), True)
    return chg


def _none(mesh: Mesh):
    """The skipped sweep: the mesh unchanged, no swap."""
    zero = torch.zeros((), dtype=torch.int64, device=mesh.device)
    return mesh, SwapStats(nswap32=zero, nswap23=zero,
                           changed_v=torch.zeros(mesh.pcap,
                                                 dtype=torch.bool,
                                                 device=mesh.device))


def swap_32(mesh: Mesh, edges, emask, t2e, active=None):
    """3-2 edge swap sweep on a compacted mesh; adjacency left stale."""
    ecap = edges.shape[0]
    tcap, pcap = mesh.tcap, mesh.pcap
    dev = mesh.device
    tet, tmask = mesh.tet, mesh.tmask

    live_e = (t2e >= 0) & tmask[:, None]
    flat_e = torch.where(live_e, t2e, ecap).reshape(-1)
    surf = common.surface_edge_mask(mesh, edges, emask)

    # ring vertices: the two off-edge corners of each local edge slot
    off = torch.as_tensor([[2, 3], [1, 3], [1, 2], [0, 3], [0, 2], [0, 1]],
                          dtype=torch.int64, device=dev)
    off1 = tet[:, off[:, 0]]
    off2 = tet[:, off[:, 1]]
    q_old, vol_all = kernels.quality_vol(mesh.vert, mesh.met, _i32(tet))

    def red(init, vals, op, dtype=torch.int32):
        return scatter(torch.full((ecap,), init, dtype=dtype, device=dev),
                       flat_e, vals, op)

    ring_sum = red(0, (off1 + off2).reshape(-1), "add")
    inc = red(0, 1, "add")
    u = red(2**30, torch.minimum(off1, off2).reshape(-1), "min")
    w = red(-1, torch.maximum(off1, off2).reshape(-1), "max")
    shell_min_q = red(math.inf, q_old[:, None].expand(tcap, 6).reshape(-1),
                      "min", q_old.dtype)
    slot6 = torch.arange(tcap, dtype=torch.int32, device=dev)[:, None] \
        .expand(tcap, 6).reshape(-1)
    smin = red(tcap, slot6, "min")
    smax = red(-1, slot6, "max")
    ssum = red(0, slot6, "add")
    v = ring_sum // 2 - u - w

    ok_ring = (u >= 0) & (v >= 0) & (w >= 0) & (u != v) & (v != w) \
        & (u != w)
    a, b = edges[:, 0], edges[:, 1]
    cand_pre = (
        emask & (inc == 3) & ~surf & ok_ring & (shell_min_q < QTHRESH)
        & ((take(mesh.vtag, a) & tags.PARBDY) == 0)
        & ((take(mesh.vtag, b) & tags.PARBDY) == 0)
    )
    if active is not None:
        # a shell's verdict changes only when a vertex of one of its
        # tets changed, and then the closure marks both endpoints
        cand_pre = cand_pre & (take(active, a) | take(active, b))
        if not bool(cand_pre.any()):
            return _none(mesh)
    K = min(ecap, max(256, ecap // 8))
    pick, valid = common.topk_candidates(cand_pre, shell_min_q, K)
    K = pick.shape[0]
    ak, bk = a[pick], b[pick]
    uk, vk, wk = u[pick], v[pick], w[pick]
    s0 = torch.clamp(smin[pick], 0, tcap - 1).long()
    s2 = torch.clamp(smax[pick], 0, tcap - 1).long()
    s1 = torch.clamp(ssum[pick] - smin[pick] - smax[pick], 0,
                     tcap - 1).long()
    shell_q = shell_min_q[pick]

    t1 = _oriented(torch.stack([uk, vk, wk, ak], dim=1), mesh.vert)
    t2 = _oriented(torch.stack([uk, wk, vk, bk], dim=1), mesh.vert)
    q12, v12 = kernels.quality_vol(mesh.vert, mesh.met,
                                   _i32(torch.cat([t1, t2], 0)))
    q1, q2 = q12[:K], q12[K:]
    v1, v2 = v12[:K], v12[K:]
    shell_vol = (vol_all[s0] + vol_all[s1]) + vol_all[s2]
    new_min = torch.minimum(q1, q2)
    pos_frac, cons_tol = common.vol_tols(mesh.dtype)
    vref = torch.clamp(shell_vol, min=1e-30)
    conserve = torch.abs((v1 + v2) - shell_vol) <= cons_tol * vref
    gain_ok = (
        (new_min > GAIN * shell_q)
        & (v1 > pos_frac * vref) & (v2 > pos_frac * vref) & conserve
    )
    tet_keys = torch.where(tmask[:, None], torch.sort(tet, dim=1).values, -1)
    exists = common.sorted_membership(
        tet_keys,
        torch.cat([
            torch.sort(torch.where(valid[:, None], t1, -1), dim=1).values,
            torch.sort(torch.where(valid[:, None], t2, -1), dim=1).values,
        ]),
        bound=pcap,
    )
    cand = valid & gain_ok & ~exists[:K] & ~exists[K:]

    def scatter_arena(vals):
        out = torch.full((tcap,), -math.inf, dtype=vals.dtype, device=dev)
        for s in (s0, s1, s2):
            out = scatter(out, s, vals, "max")
        return out

    def gather_arena(av):
        return torch.maximum(torch.maximum(av[s0], av[s1]), av[s2])

    win = common.rank_winners(new_min - shell_q, cand, scatter_arena,
                              gather_arena)

    def apply(wset):
        t_o = scatter(tet, common.unique_oob(wset, s0, tcap), t1)
        t_o = scatter(t_o, common.unique_oob(wset, s1, tcap), t2)
        tm_o = scatter(tmask, common.unique_oob(wset, s2, tcap), False)
        return t_o, tm_o

    tet_new, tmask_new = apply(win)
    # duplicate post-check (cross-swap interactions), then rebuild
    dup = common.duplicate_tets(tet_new, tmask_new, bound=pcap)
    win2 = win & ~((dup[s0] | dup[s1]) & win)
    tet_out, tmask_out = apply(win2)
    out = mesh.replace(tet=tet_out, tmask=tmask_out)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return out, SwapStats(nswap32=win2.to(torch.int32).sum(), nswap23=zero,
                          changed_v=_mark_changed(pcap, win2,
                                                  (uk, vk, wk, ak, bk)))


def swap_23(mesh: Mesh, edges, emask, active=None):
    """2-3 face swap sweep. Requires fresh adjacency; leaves it stale."""
    tcap, pcap = mesh.tcap, mesh.pcap
    dev = mesh.device
    tet, tmask, adja = mesh.tet, mesh.tmask, mesh.adja
    ne0 = mesh.ntet

    nb_full = adja.reshape(-1).long()
    t_id_full = torch.arange(tcap * 4, device=dev) // 4
    t2_full = torch.clamp(nb_full // 4, 0, tcap - 1)
    q_all, _ = kernels.quality_vol(mesh.vert, mesh.met, _i32(tet))
    qmin_pair = torch.minimum(q_all[t_id_full], q_all[t2_full])
    pre = (
        (nb_full >= 0) & tmask[t2_full] & tmask[t_id_full]
        & (t_id_full < t2_full) & (qmin_pair < QTHRESH)
    )
    if active is not None:
        # a face pair's verdict changes only when a vertex of either
        # tet's 1-ring changed
        tet_act = torch.any(take(active, tet), dim=1)
        pre = pre & (tet_act[t_id_full] | tet_act[t2_full])
        if not bool(pre.any()):
            return _none(mesh)
    K = max(256, tcap // 2)
    sortkey = torch.where(pre, qmin_pair, math.inf)
    pick, valid = common.topk_candidates(pre, sortkey, K)
    K = pick.shape[0]
    t_id = pick // 4
    f_id = pick % 4
    nb = nb_full[pick]
    t2c = torch.clamp(nb // 4, 0, tcap - 1)

    fvidx = torch.as_tensor(FACE_VERTS, dtype=torch.int64, device=dev)[f_id]
    fv = torch.gather(tet[t_id], 1, fvidx)               # [K,3]
    d1 = tet[t_id, f_id]
    d2 = tet[t2c, nb % 4]
    old_min = torch.minimum(q_all[t_id], q_all[t2c])

    elo, ehi = torch.minimum(d1, d2), torch.maximum(d1, d2)
    ekeys = torch.where(emask[:, None], edges, -1)
    equery = torch.stack([torch.where(valid, elo, -1),
                          torch.where(valid, ehi, -1)], dim=1)
    edge_exists = common.sorted_membership(ekeys, equery, bound=pcap)
    fsort = torch.sort(fv, dim=1).values
    trkeys = torch.sort(torch.where(mesh.trmask[:, None], mesh.tria, -1),
                        dim=1).values
    face_has_tria = common.sorted_membership(
        trkeys, torch.where(valid[:, None], fsort, -1), bound=pcap)

    x, y, z = fv[:, 0], fv[:, 1], fv[:, 2]
    cands = [
        _oriented(torch.stack([x, y, d1, d2], dim=1), mesh.vert),
        _oriented(torch.stack([y, z, d1, d2], dim=1), mesh.vert),
        _oriented(torch.stack([z, x, d1, d2], dim=1), mesh.vert),
    ]
    qcat, vcat = kernels.quality_vol(mesh.vert, mesh.met,
                                     _i32(torch.cat(cands, 0)))
    qs = [qcat[:K], qcat[K:2 * K], qcat[2 * K:]]
    vs = [vcat[:K], vcat[K:2 * K], vcat[2 * K:]]
    new_min = torch.minimum(torch.minimum(qs[0], qs[1]), qs[2])
    vol_old2 = common.vol_of(mesh.vert, tet)
    pair_vol = vol_old2[t_id] + vol_old2[t2c]
    pos_frac, cons_tol = common.vol_tols(mesh.dtype)
    vref = torch.clamp(pair_vol, min=1e-30)
    conserve = torch.abs(((vs[0] + vs[1]) + vs[2]) - pair_vol) \
        <= cons_tol * vref
    vol_ok = (
        (vs[0] > pos_frac * vref) & (vs[1] > pos_frac * vref)
        & (vs[2] > pos_frac * vref) & conserve
    )
    cand = (
        valid & (old_min < QTHRESH) & ~edge_exists & ~face_has_tria
        & vol_ok & (new_min > GAIN * old_min)
    )

    def scatter_arena(vals):
        out = torch.full((tcap,), -math.inf, dtype=vals.dtype, device=dev)
        out = scatter(out, t_id, vals, "max")
        return scatter(out, t2c, vals, "max")

    def gather_arena(av):
        return torch.maximum(av[t_id], av[t2c])

    win = common.rank_winners(new_min - old_min, cand, scatter_arena,
                              gather_arena)
    # capacity: one appended tet per winner
    rank = torch.cumsum(win.long(), 0) - 1
    win = win & (ne0 + rank + 1 <= tcap)
    rank = torch.cumsum(win.long(), 0) - 1
    app = ne0 + rank

    def apply(wset):
        t_o = scatter(tet, common.unique_oob(wset, t_id, tcap),
                           cands[0])
        t_o = scatter(t_o, common.unique_oob(wset, t2c, tcap),
                           cands[1])
        tgt_c = common.unique_oob(wset, app, tcap)
        t_o = scatter(t_o, tgt_c, cands[2])
        return t_o, scatter(tmask, tgt_c, wset)

    tet_out, tmask_out = apply(win)
    dup = common.duplicate_tets(tet_out, tmask_out, bound=pcap)
    bad = (dup[torch.clamp(t_id, 0, tcap - 1)] | dup[t2c]
           | dup[torch.clamp(app, 0, tcap - 1)]) & win
    win2 = win & ~bad
    tet_out, tmask_out = apply(win2)
    tref_out = scatter(mesh.tref, common.unique_oob(win2, app, tcap),
                       mesh.tref[t_id])
    out = mesh.replace(tet=tet_out.to(torch.int32), tref=tref_out,
                       tmask=tmask_out)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return out, SwapStats(nswap32=zero, nswap23=win2.to(torch.int32).sum(),
                          changed_v=_mark_changed(pcap, win2,
                                                  (x, y, z, d1, d2)))
