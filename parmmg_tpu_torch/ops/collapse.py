"""Batched edge collapse: coarsen every metric-short edge in parallel.

Counterpart of `parmmg_tpu/ops/collapse.py` (`collapse_short_edges`,
full-table sweep, the fixed 3 x 5 select/evaluate schedule the JAX
package runs off the TPU). A candidate short edge (src->dst) removes src
and retargets its ball onto dst; the arena is the union of tets touching
either endpoint. Validity: positive volumes and bounded quality loss
(the `collapse_cavity` kernel scores the retargeted ball), surface
fidelity for boundary collapses, and a duplicate-tet link check.

Frontier mode: with an `active` vertex mask only short edges near the
frontier are candidates, and with none the sweep launches nothing (a
host decision where the JAX package takes a `lax.cond`).
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
from .analysis import _cross, _dot, _norm, surf_tria_mask
from .common import scatter, take

_FEAT_BITS = tags.RIDGE | tags.REF | tags.NOM
_HARD = tags.REQUIRED | tags.CORNER | tags.PARBDY | tags.NOM | tags.OVERLAP
_COS_SURF = 0.70710678


class CollapseStats(NamedTuple):
    ncollapse: torch.Tensor
    ncand: torch.Tensor
    nrej_geom: torch.Tensor
    nrej_topo: torch.Tensor
    nrej_surf: torch.Tensor
    nsurf: torch.Tensor
    changed_v: torch.Tensor  # [PC] bool: vertices whose 1-ring changed


def _i32(t):
    return t.to(torch.int32).contiguous()


def _retarget(conn, mask, wv, src, dst):
    """Per-row winner and role of a connectivity table ([N,k]): (e, has,
    e_s, is_shell, is_ball, new_conn) with src retargeted onto dst in
    ball rows."""
    e = take(wv, conn).max(dim=1).values
    has = (e >= 0) & mask
    e_s = torch.clamp(e, min=0).long()
    src_r, dst_r = src[e_s], dst[e_s]
    has_src = torch.any(conn == src_r[:, None], dim=1) & has
    has_dst = torch.any(conn == dst_r[:, None], dim=1) & has
    is_shell = has_src & has_dst
    is_ball = has_src & ~is_shell
    new = torch.where((conn == src_r[:, None]) & is_ball[:, None],
                      dst_r[:, None], conn)
    return e, has, e_s, is_shell, is_ball, new


def collapse_short_edges(mesh: Mesh, edges, emask, t2e,
                         lshrt: float = float(metric_mod.LSHRT),
                         hausd=0.01, nosurf: bool = False, active=None):
    """One collapse sweep on a compacted mesh; returns (mesh,
    CollapseStats). Adjacency is left stale."""
    ecap = edges.shape[0]
    tcap, pcap = mesh.tcap, mesh.pcap
    dev = mesh.device
    tet, tmask = mesh.tet, mesh.tmask

    a, b = edges[:, 0], edges[:, 1]
    l = metric_mod.edge_length(take(mesh.vert, a), take(mesh.vert, b),
                               take(mesh.met, a), take(mesh.met, b))
    pre = emask & (l < lshrt)
    if active is not None:
        # an inactive short edge met the same ball last sweep and did
        # not act
        pre = pre & (take(active, a) | take(active, b))
        if not bool(pre.any()):
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            return mesh, CollapseStats(
                ncollapse=zero, ncand=zero, nrej_geom=zero, nrej_topo=zero,
                nrej_surf=zero, nsurf=zero,
                changed_v=torch.zeros(pcap, dtype=torch.bool, device=dev))

    # --- vertex classes ---------------------------------------------------
    vt = mesh.vtag
    hard = (vt & _HARD) != 0
    bdy_v = (vt & tags.BDY) != 0
    feat_v = (vt & _FEAT_BITS) != 0
    free_i = mesh.vmask & ~hard & ~bdy_v
    surf_v = mesh.vmask & ~hard & bdy_v & ~feat_v
    ridge_v = mesh.vmask & ~hard & bdy_v & feat_v
    score = 3 * free_i.to(torch.int32) + 2 * surf_v.to(torch.int32) \
        + ridge_v.to(torch.int32)
    if nosurf:
        score = torch.where(free_i, 3, 0).to(torch.int32)

    sa, sb = take(score, a), take(score, b)
    src_is_a = sa >= sb
    src = torch.where(src_is_a, a, b).long()
    dst = torch.where(src_is_a, b, a).long()
    s_src = torch.maximum(sa, sb)

    # --- arena: tets containing src or dst --------------------------------
    def scatter_arena(vals):
        vb = torch.full((pcap,), -math.inf, dtype=vals.dtype, device=dev)
        vb = scatter(vb, src, vals, "max")
        vb = scatter(vb, dst, vals, "max")
        tv = take(vb, tet).max(dim=1).values
        return torch.where(tmask, tv, -math.inf)

    def gather_arena(tv):
        ub = torch.full((pcap,), -math.inf, dtype=tv.dtype, device=dev)
        idx = torch.where(tmask[:, None], tet, pcap)
        ub = scatter(ub, idx.reshape(-1),
                     tv[:, None].expand(tcap, 4).reshape(-1), "max")
        return torch.maximum(take(ub, src), take(ub, dst))

    # --- edge classes -----------------------------------------------------
    smask = surf_tria_mask(mesh)
    tri_keys = common.tria_edge_keys(mesh, smask)
    surf_e = common.sorted_membership(
        tri_keys, torch.where(emask[:, None], edges, -1), bound=pcap)
    feat = common.feature_edge_index(mesh, edges, emask)
    feat_tag = torch.where(feat >= 0, take(mesh.edtag, feat), 0)
    feat_e = (feat_tag & _FEAT_BITS) != 0
    legal = (s_src == 3) | ((s_src == 2) & surf_e) | ((s_src == 1) & feat_e)
    cand = pre & legal
    ncand = cand.to(torch.int32).sum()

    # win-independent quantities (one fused quality+volume pass)
    q_old, vol_old = kernels.quality_vol(mesh.vert, mesh.met, _i32(tet))
    vol_floor = common.POS_VOL_FRAC * torch.abs(vol_old)

    def raw_normal(tri):
        p0 = take(mesh.vert, tri[:, 0])
        p1 = take(mesh.vert, tri[:, 1])
        p2 = take(mesh.vert, tri[:, 2])
        return _cross(p1 - p0, p2 - p0)

    r_old = raw_normal(mesh.tria)
    n_old = _norm(r_old)
    req_tria = (mesh.trtag & tags.REQUIRED) != 0
    eidx = torch.arange(ecap, dtype=torch.int32, device=dev)
    if isinstance(hausd, torch.Tensor) and hausd.dim() > 0:
        hausd_f = take(hausd, torch.clamp(mesh.trref, 0,
                                          hausd.shape[0] - 1))
    else:
        hausd_f = float(hausd)

    def winner_map(win):
        wv = torch.full((pcap,), -1, dtype=torch.int32, device=dev)
        wv = scatter(wv, torch.where(win, src, pcap), eidx, "max")
        return scatter(wv, torch.where(win, dst, pcap), eidx, "max")

    def none_e():
        return torch.zeros(ecap, dtype=torch.bool, device=dev)

    def eval_winners(win):
        """Validity of a winner set with pairwise-disjoint arenas:
        (accept, rej_geom, rej_surf, rej_topo)."""
        wv = winner_map(win)
        e_t, has, e_ts, is_shell, is_ball, new_tet = _retarget(
            tet, tmask, wv, src, dst)
        gate_new = kernels.collapse_cavity(mesh.vert, mesh.met,
                                           _i32(new_tet), vol_floor)
        tgt = torch.where(is_ball, e_t, ecap)
        inf = torch.full((ecap,), math.inf, dtype=q_old.dtype, device=dev)
        ball_old = scatter(inf, tgt, q_old, "min")
        ball_new = scatter(inf, tgt, gate_new, "min")
        ok_geom = (ball_new >= 0.3 * ball_old) | (ball_new >= 0.3)
        ok_geom = ok_geom & (ball_new > 0.02) & torch.isfinite(ball_new)
        rej_geom = win & ~ok_geom
        accept = win & ok_geom

        # surface fidelity for boundary collapses (chkcol_bdy role)
        e_f, fhas, e_fs, f_shell, f_ball, new_tria = _retarget(
            mesh.tria, mesh.trmask, wv, src, dst)
        r_new = raw_normal(new_tria)
        n_new = _norm(r_new)
        dotn = _dot(r_old, r_new) / torch.clamp(n_old * n_new, min=1e-30)
        unit_new = r_new / torch.clamp(n_new, min=1e-30)[:, None]
        dist = torch.abs(_dot(unit_new, take(mesh.vert, src[e_fs])
                              - take(mesh.vert, new_tria[:, 0])))
        degen = n_new < 1e-12 * torch.clamp(n_old, min=1e-30)
        tria_bad = f_ball & ((dotn < _COS_SURF) | (dist > hausd_f) | degen)
        bad_surf = scatter(none_e(), torch.where(
            tria_bad | (fhas & req_tria), e_f, ecap), True)
        rej_surf = accept & bad_surf
        accept = accept & ~bad_surf

        # topological check: tentative apply + duplicate detection
        app_t = is_ball & accept[e_ts]
        del_t = is_shell & accept[e_ts]
        tet_tent = torch.where(app_t[:, None], new_tet, tet)
        dup = common.duplicate_tets(tet_tent, tmask & ~del_t, bound=pcap)
        bad_e = scatter(none_e(), torch.where(dup & has, e_t, ecap), True)
        rej_topo = accept & bad_e
        accept = accept & ~bad_e
        return accept, rej_geom, rej_surf, rej_topo

    # Select -> evaluate -> commit, 3 rounds of 5 selections: committed
    # winners hold their arenas with +inf, rejected ones release them.
    if ecap < (1 << 24):
        h24 = common._hash(ecap, dev)
        order = common.lexsort((h24, torch.where(cand, l, math.inf)))
        rnk = torch.zeros(ecap, dtype=torch.float32, device=dev)
        rnk[order] = torch.arange(ecap, 0, -1, device=dev).to(torch.float32)

        def select_round(w_acc, rej, sup):
            act = cand & ~w_acc & ~rej & ~sup
            pv = torch.where(act, rnk, -math.inf)
            pv = torch.where(w_acc, math.inf, pv)
            best = gather_arena(scatter_arena(pv))
            return act & (rnk >= best), act & torch.isinf(best)
    else:
        def select_round(w_acc, rej, sup):
            act = cand & ~w_acc & ~rej & ~sup
            one = torch.where(w_acc, 1.0, -math.inf).to(torch.float32)
            blocked = gather_arena(scatter_arena(one)) > 0.0
            w = common.two_phase_winners(-l, act & ~blocked, scatter_arena,
                                         gather_arena)
            return w, act & blocked

    win_acc, rej_g, rej_s, rej_t = none_e(), none_e(), none_e(), none_e()
    for _ in range(3):
        rej = rej_g | rej_s | rej_t
        trial, sup = win_acc, none_e()
        for _ in range(5):
            w, sup_add = select_round(trial, rej, sup)
            trial, sup = trial | w, sup | sup_add
        win_acc, rg, rs, rt = eval_winners(trial)
        rej_g, rej_s, rej_t = rej_g | rg, rej_s | rs, rej_t | rt

    # final pass: apply intermediates + one duplicate guard on exactly the
    # applied configuration
    win = win_acc
    wv = winner_map(win)
    e_t, has, e_ts, is_shell, is_ball, new_tet = _retarget(
        tet, tmask, wv, src, dst)
    e_f, fhas, e_fs, f_shell, f_ball, new_tria = _retarget(
        mesh.tria, mesh.trmask, wv, src, dst)
    dup = common.duplicate_tets(
        torch.where((is_ball & win[e_ts])[:, None], new_tet, tet),
        tmask & ~(is_shell & win[e_ts]), bound=pcap,
    )
    bad_e = scatter(none_e(), torch.where(dup & has, e_t, ecap), True)
    accept = win & ~bad_e
    nrej_geom = rej_g.to(torch.int32).sum()
    nrej_surf = rej_s.to(torch.int32).sum()
    nrej_topo = (rej_t | bad_e).to(torch.int32).sum()

    # --- final apply ------------------------------------------------------
    app_t = is_ball & accept[e_ts]
    del_t = is_shell & accept[e_ts]
    tet_out = torch.where(app_t[:, None], new_tet, tet)
    tmask_out = tmask & ~del_t
    vmask_out = scatter(mesh.vmask, torch.where(accept, src, pcap), False)
    app_f = f_ball & accept[e_fs]
    del_f = f_shell & accept[e_fs]
    tria_out = torch.where(app_f[:, None], new_tria, mesh.tria)
    trmask_out = mesh.trmask & ~del_f
    e_e, ehas, e_es, g_shell, g_ball, new_edge = _retarget(
        mesh.edge, mesh.edmask, wv, src, dst)
    app_g = g_ball & accept[e_es]
    del_g = g_shell & accept[e_es]
    edge_out = torch.where(app_g[:, None], new_edge, mesh.edge)
    edmask_out = mesh.edmask & ~del_g

    ncollapse = accept.to(torch.int32).sum()
    nsurf = (accept & (s_src < 3)).to(torch.int32).sum()
    # frontier: every vertex of a retargeted or deleted tet (deleted
    # shells still name their vertices, src and the ring included)
    chg = scatter(torch.zeros(pcap, dtype=torch.bool, device=dev),
                  torch.where((app_t | del_t)[:, None], new_tet,
                              pcap).reshape(-1), True)
    chg = scatter(chg, torch.where(accept, dst, pcap), True)
    out = mesh.replace(
        tet=tet_out.to(torch.int32), tmask=tmask_out, vmask=vmask_out,
        tria=tria_out.to(torch.int32), trmask=trmask_out,
        edge=edge_out.to(torch.int32), edmask=edmask_out,
    )
    return out, CollapseStats(
        ncollapse=ncollapse, ncand=ncand, nrej_geom=nrej_geom,
        nrej_topo=nrej_topo, nrej_surf=nrej_surf, nsurf=nsurf,
        changed_v=chg,
    )
