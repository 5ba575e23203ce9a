"""Interface displacement and shard-to-shard tet migration between
iterations.

Counterpart of `parmmg_tpu/parallel/migrate.py` on stacked tensors (a
leading shard axis, `distribute.stack_meshes`): plain loops over the
shards where the JAX package vmaps.

- `displace_colors`: the advancing-front interface displacement — every
  tet face-adjacent (locally through `adja`, across shards through an
  open face whose corners agree through the node-table halo) to a
  higher-priority color adopts it, `layers` times, with a floor on the
  global color counts.
- `fix_contiguity`: reattaches the color components the front pinched
  off (host numpy over connectivity, as in the JAX package).
- `migrate`: outgoing tets, with their vertex payloads, real trias and
  feature edges addressed by global vertex ids, are packed into
  fixed-capacity per-destination slots, exchanged by an axis swap and
  integrated on the receiving shard by sort-merge gid matching.
  `CapacityError` is raised when a slot or a shard capacity falls short.
- `retag_interfaces`: re-derives PARBDY vertex bits from global gid
  multiplicity and the synthetic interface trias from cross-shard open
  faces, then the node tables (the device arm, the JAX default; the host
  arm selected by `PARMMG_HOST_RETAG` is not ported: ROADMAP queue 1).
- `BalancePolicy`: the band-with-hysteresis controller over the measured
  per-shard work of the history records.
- `frontier_gid_keys` / `frontier_from_gid_keys`: the frontier carry
  encoded as global ids across the exchange.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import adjacency, tags
from ..core.mesh import FACE_VERTS, Mesh
from ..models.adapt import CapacityError
from ..ops import common
from ..ops.common import scatter, take, unique_oob
from .comm import halo_max
from .distribute import ShardComm, rebuild_comm, stack_meshes, unstack_mesh


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _cumrank(sel) -> torch.Tensor:
    """Inclusive count of `sel` minus one: each selected row's rank."""
    return torch.cumsum(sel.to(torch.int64), 0) - 1


def stacked_adjacency(stacked: Mesh) -> Mesh:
    """`build_adjacency` on every shard of a stacked mesh."""
    return stack_meshes([adjacency.build_adjacency(m)
                         for m in unstack_mesh(stacked)])


# ---------------------------------------------------------------------------
# closed-loop balance policy (host)
# ---------------------------------------------------------------------------

# default band: fire only past 1.5x max/mean measured work
BALANCE_BAND_DEFAULT = 1.5

# a PERF_DB named here would derive the band from the history records
BALANCE_DB_ENV = "PMMGTPU_PERF_DB"


def resolve_balance_band(opts) -> Optional[float]:
    """Effective work-imbalance band: `opts.balance_band` when set, else
    the PMMGTPU_BALANCE_BAND environment variable, else the default. A
    band <= 0 disables the closed loop (interface displacement and the
    grps_ratio guard run either way). A band derived from a PERF_DB
    (`PMMGTPU_PERF_DB` naming an existing file) needs the history
    records of `obs/`, which ROADMAP queue 1, item 15 brings: refused."""
    band = getattr(opts, "balance_band", None)
    if band is None:
        env = os.environ.get("PMMGTPU_BALANCE_BAND")
        if env:
            band = float(env)
        else:
            path = os.environ.get(BALANCE_DB_ENV, "")
            if path and os.path.exists(path):
                raise NotImplementedError(
                    f"{BALANCE_DB_ENV}={path}: a balance band derived from "
                    "the PERF_DB history is not ported yet — ROADMAP queue "
                    "1, item 15 (obs/history) brings it; set -balance or "
                    "PMMGTPU_BALANCE_BAND")
            band = BALANCE_BAND_DEFAULT
    band = float(band)
    return band if band > 0 else None


def measured_shard_work(history: List[dict], it: int) -> Optional[list]:
    """Per-shard measured work of iteration `it`: the sum over its sweep
    records of `shard_active[i] * shard_ne[i]`; the last record's raw
    `shard_ne` when every sweep was drained; None when the iteration
    left no distributed record."""
    rows = [r for r in history
            if r.get("iter") == it and "shard_ne" in r
            and "failure" not in r]
    if not rows:
        return None
    d = len(rows[-1]["shard_ne"])
    work = [0.0] * d
    for r in rows:
        act = r.get("shard_active") or [1.0] * d
        for i, (a, ne) in enumerate(zip(act, r["shard_ne"])):
            work[i] += float(a) * float(ne)
    if max(work) <= 0.0:
        work = [float(x) for x in rows[-1]["shard_ne"]]
    return work


class BalancePolicy:
    """Band-with-hysteresis controller over the measured work imbalance,
    evaluated once per iteration at the balancing boundary.

    - imbalance < `low_water` re-arms the controller (strikes reset);
    - `low_water` <= imbalance <= `band` holds;
    - imbalance > `band` fires unless the last firing was fewer than
      `min_interval` iterations ago: first ``displace`` (the standing
      interface displacement is the corrective action), a repeat firing
      ``recut`` (a full SFC re-cut).

    Decisions read only the history records."""

    def __init__(self, band: float, low_water: Optional[float] = None,
                 min_interval: int = 2):
        self.band = float(band)
        self.low_water = (float(low_water) if low_water is not None
                          else 1.0 + 0.5 * (self.band - 1.0))
        self.min_interval = int(min_interval)
        self._last_fire: Optional[int] = None
        self._strikes = 0

    def evaluate(self, history: List[dict], it: int) -> dict:
        """Decision for iteration `it`: dict(imbalance, work, action,
        reason) with action in (None, "displace", "recut")."""
        work = measured_shard_work(history, it)
        if work is None:
            return dict(imbalance=None, work=None, action=None,
                        reason="no-telemetry")
        imb = round(max(work) / max(sum(work) / len(work), 1e-9), 4)
        out = dict(imbalance=imb, work=work, action=None, reason="")
        if imb < self.low_water:
            self._strikes = 0
            out["reason"] = "in-band"
            return out
        if imb <= self.band:
            out["reason"] = "hysteresis-hold"
            return out
        if (self._last_fire is not None
                and it - self._last_fire < self.min_interval):
            out["reason"] = "throttled"
            return out
        self._strikes += 1
        self._last_fire = it
        if self._strikes >= 2:
            self._strikes = 0
            out.update(action="recut", reason="band-exceeded-again")
        else:
            out.update(action="displace", reason="band-exceeded")
        return out


# ---------------------------------------------------------------------------
# interface displacement
# ---------------------------------------------------------------------------

def _color_prio(nparts: int, round_id: int, device) -> torch.Tensor:
    """Fixed deterministic priority permutation of the colors (constant
    across iterations, round_id=0, so fronts move monotonically)."""
    pr = ((np.arange(nparts, dtype=np.int64) * 40503 + round_id * 25173)
          * 2654435761) % (1 << 16)
    return torch.as_tensor(pr, dtype=torch.int32, device=device)


def displace_colors(stacked: Mesh, comm: ShardComm, nparts: int,
                    round_id: int = 0, layers: int = 2,
                    min_elts: int = 8) -> torch.Tensor:
    """[D,T] int32 destination color per tet (its own shard where kept).

    Per layer, a tet adopts the best (priority, color) among its
    face-neighbours' colors — across shards only through an open face
    whose three corners carry the same color through the halo — unless
    the global count of its color would fall below `min_elts`."""
    if nparts > 256:
        raise ValueError(
            "displace_colors packs (prio, color) in radix 256; "
            f"nparts={nparts} needs a wider encoding")
    d, tcap = stacked.tmask.shape
    pcap = stacked.vmask.shape[1]
    dev = stacked.device
    prio = _color_prio(nparts, round_id, dev)
    tmask = stacked.tmask
    color = torch.where(
        tmask, torch.arange(d, dtype=torch.int32, device=dev)[:, None],
        -1).to(torch.int32)
    nb = (stacked.adja >> 2).long().clamp(min=0)
    valid_nb = (stacked.adja >= 0) & tmask[:, :, None]
    par_v = (stacked.vtag & tags.PARBDY) != 0
    tet = stacked.tet.long()
    fv = torch.as_tensor(FACE_VERTS, dtype=torch.int64, device=dev)

    def enc(c):
        return torch.where(c >= 0, prio[c.clamp(min=0).long()] * 256 + c,
                           -1)

    for _ in range(layers):
        enc_t = enc(color)                                     # [D,T]
        nb_enc = torch.where(
            valid_nb,
            torch.gather(enc_t, 1, nb.reshape(d, -1)).reshape(d, tcap, 4),
            -1)
        best_local = nb_enc.max(dim=2).values
        # interface vertices carry the max enc of their incident tets,
        # agreed through the halo
        venc = []
        for s in range(d):
            idx = torch.where(tmask[s][:, None], tet[s], pcap).reshape(-1)
            venc.append(scatter(
                torch.full((pcap,), -1, dtype=torch.int32, device=dev),
                idx, enc_t[s].repeat_interleave(4), "max"))
        venc = torch.where(par_v, torch.stack(venc), -1)
        venc = torch.where(par_v, halo_max(venc, comm.comm_idx), -1)
        best_ifc = torch.full_like(enc_t, -1)
        for f in range(4):
            fverts = tet[:, :, fv[f]]                          # [D,T,3]
            ve = torch.gather(venc, 1, fverts.reshape(d, -1)).reshape(
                d, tcap, 3)
            open_f = (stacked.adja[:, :, f] < 0) & tmask
            all_pos = torch.all(ve >= 0, dim=2)
            col = torch.where(ve >= 0, ve % 256, -1)
            same_col = ((col[..., 0] == col[..., 1])
                        & (col[..., 1] == col[..., 2]))
            fenc = ve.min(dim=2).values
            ok = open_f & all_pos & same_col
            best_ifc = torch.maximum(best_ifc, torch.where(ok, fenc, -1))
        best = torch.maximum(best_local, best_ifc)
        bestcol = best % 256
        flip = tmask & (best > enc_t) & (best >= 0)
        # starvation floor on the global color counts
        safe_c = torch.where(tmask, color.clamp(min=0), 0).long()
        zeros = torch.zeros((d, nparts), dtype=torch.int32, device=dev)
        g_counts = zeros.scatter_add(1, safe_c, _i32(tmask)).sum(0)
        g_losses = zeros.scatter_add(1, safe_c, _i32(flip)).sum(0)
        starved = (g_counts - g_losses) < min_elts
        flip = flip & ~starved[safe_c]
        color = torch.where(flip, bestcol, color).to(torch.int32)
    return color


def fix_contiguity(stacked: Mesh, color: torch.Tensor, nparts: int,
                   rounds: int = 2) -> torch.Tensor:
    """Reattach stranded color components after the front displacement:
    connected components of the same-color tet graph (face adjacency in
    a shard, gid-matched open faces across shards) by min-label
    propagation with pointer jumping; each color keeps its heaviest
    component and every other component takes its majority adjacent
    color. Host numpy over the connectivity, read once. Takes and
    returns the [D,T] colors of `displace_colors`."""
    col = color.cpu().numpy().copy()
    adja = stacked.adja.cpu().numpy()
    tmask = stacked.tmask.cpu().numpy()
    tet = stacked.tet.cpu().numpy()
    vglob = stacked.vglob.cpu().numpy()
    S, TC = col.shape
    N = S * TC
    live = tmask.reshape(-1)
    colf = col.reshape(-1)

    # --- adjacency pairs: within-shard faces --------------------------
    nb = adja >> 2
    valid = (adja >= 0) & tmask[:, :, None]
    t_id = np.broadcast_to(np.arange(TC)[None, :, None], nb.shape)
    base = np.broadcast_to((np.arange(S) * TC)[:, None, None], nb.shape)
    a_in = (base + t_id)[valid]
    b_in = (base + np.where(valid, nb, 0))[valid]
    once = a_in < b_in
    pairs_a = [a_in[once]]
    pairs_b = [b_in[once]]

    # --- cross-shard: open faces matched by sorted gid triples --------
    open_f = (adja < 0) & tmask[:, :, None]
    s_i, t_i, f_i = np.nonzero(open_f)
    if len(s_i):
        fv = np.asarray(FACE_VERTS)
        corners = tet[s_i, t_i][np.arange(len(t_i))[:, None], fv[f_i]]
        g3 = np.sort(vglob[s_i[:, None], corners], axis=1).astype(np.int64)
        node = s_i.astype(np.int64) * TC + t_i
        order = np.lexsort((g3[:, 2], g3[:, 1], g3[:, 0]))
        g3s, nodes = g3[order], node[order]
        samekey = np.all(g3s[1:] == g3s[:-1], axis=1)
        # matched interface faces come in pairs; gid >= 0 guards unset ids
        ok = samekey & np.all(g3s[1:] >= 0, axis=1)
        pairs_a.append(nodes[:-1][ok])
        pairs_b.append(nodes[1:][ok])
    A = np.concatenate(pairs_a)
    B = np.concatenate(pairs_b)

    for _ in range(rounds):
        same = (colf[A] == colf[B]) & (colf[A] >= 0)
        a, b = A[same], B[same]
        lab = np.arange(N, dtype=np.int64)
        for _ in range(64):
            l2 = lab.copy()
            np.minimum.at(l2, a, lab[b])
            np.minimum.at(l2, b, lab[a])
            l2 = np.minimum(l2, l2[l2])
            l2 = np.minimum(l2, l2[l2])
            if (l2 == lab).all():
                break
            lab = l2
        while True:
            l2 = lab[lab]
            if (l2 == lab).all():
                break
            lab = l2

        sel = live & (colf >= 0)
        roots, inv, cnts = np.unique(lab[sel], return_inverse=True,
                                     return_counts=True)
        if not len(roots):
            break
        root_col = np.zeros(len(roots), np.int64)
        root_col[inv] = colf[sel]  # every member shares the color
        # heaviest component per color survives
        byc = np.lexsort((cnts, root_col))
        last = np.concatenate(
            [root_col[byc][1:] != root_col[byc][:-1], [True]])
        main_roots = roots[byc[last]]
        stranded_root = np.ones(len(roots), bool)
        stranded_root[np.searchsorted(roots, main_roots)] = False
        if not stranded_root.any():
            break

        # majority adjacent color per stranded component, over the
        # color-crossing adjacency edges
        diff = (colf[A] != colf[B]) & (colf[A] >= 0) & (colf[B] >= 0)
        ca = np.concatenate([A[diff], B[diff]])
        cb = np.concatenate([B[diff], A[diff]])
        ra = lab[ca]
        ri = np.searchsorted(roots, ra)
        inb = (ri < len(roots)) & (roots[np.minimum(ri, len(roots) - 1)]
                                   == ra)
        strand_e = inb & stranded_root[np.minimum(ri, len(roots) - 1)]
        if not strand_e.any():
            break
        er, ec = ra[strand_e], colf[cb[strand_e]]
        key = er * np.int64(nparts) + ec
        uk, kcnt = np.unique(key, return_counts=True)
        kr = uk // nparts
        byr = np.lexsort((kcnt, kr))
        lastr = np.concatenate([kr[byr][1:] != kr[byr][:-1], [True]])
        win_root, win_col = kr[byr[lastr]], (uk % nparts)[byr[lastr]]
        dest = np.full(N, -1, np.int64)
        dest[win_root] = win_col
        node_sel = sel & (dest[lab] >= 0)
        # only stranded members move (main components are not in dest)
        colf[node_sel] = dest[lab[node_sel]]

    return torch.as_tensor(colf.reshape(S, TC).astype(np.int32),
                           device=color.device)


# ---------------------------------------------------------------------------
# migration (pack -> exchange -> integrate)
# ---------------------------------------------------------------------------

def _outgoing(stacked: Mesh, color: torch.Tensor) -> torch.Tensor:
    """[D,T] bool: live tets whose color is another shard."""
    d = color.shape[0]
    sid = torch.arange(d, dtype=color.dtype, device=color.device)[:, None]
    return stacked.tmask & (color >= 0) & (color != sid)


def migration_counts(stacked: Mesh, color: torch.Tensor,
                     nparts: int) -> torch.Tensor:
    """[D,D] int32 outgoing tet counts per (source, destination)."""
    out = _outgoing(stacked, color)
    safe = torch.where(out, color, 0).long()
    cnt = torch.zeros((color.shape[0], nparts), dtype=torch.int32,
                      device=color.device)
    return cnt.scatter_add(1, safe, _i32(out))


def _slots(buf, sel, rows):
    """`buf` with the rows of `rows` where `sel` written to consecutive
    slots in row order (rows past the capacity dropped)."""
    return scatter(buf, unique_oob(sel, _cumrank(sel), buf.shape[0]), rows)


def _pack_shard(m: Mesh, out_s, color_s, d: int, slot_cap: int,
                tria_cap: int, edge_cap: int):
    """One source shard's per-destination slot buffers, the kept tria
    and edge masks, and the [3, D] per-destination counts."""
    dev = m.device
    pcap = m.pcap
    fv = torch.as_tensor(FACE_VERTS, dtype=torch.int64, device=dev)
    # --- tets -------------------------------------------------------------
    ti = _i32(torch.cat([take(m.vglob, m.tet), m.tref[:, None],
                         take(m.vtag, m.tet), take(m.vref, m.tet)], 1))
    fpay = torch.cat([m.vert, m.met, m.ls, m.disp, m.fields], 1)
    tf = take(fpay, m.tet)                                  # [T,4,Wf]
    buf_ti = torch.full((d, slot_cap, 13), -1, dtype=torch.int32,
                        device=dev)
    buf_tf = torch.zeros((d, slot_cap, 4, tf.shape[-1]), dtype=m.dtype,
                         device=dev)
    n_t, n_f, n_e = ([0] * d for _ in range(3))
    for dst in range(d):
        sel = out_s & (color_s == dst)
        n_t[dst] = sel.sum()
        buf_ti[dst] = _slots(buf_ti[dst], sel, ti)
        buf_tf[dst] = _slots(buf_tf[dst], sel, tf)
    # --- real trias owned by moving tets -----------------------------------
    fkeys = torch.sort(m.tet[:, fv].reshape(-1, 3), dim=1).values
    fkeys = torch.where(m.tmask.repeat_interleave(4)[:, None], fkeys, -1)
    syn = tags.pure_interface_tria(m.trtag)
    real_tr = m.trmask & ~syn
    trkeys = torch.sort(torch.where(real_tr[:, None], m.tria, -1),
                        dim=1).values
    fid1, fid2, cnt = common.match_rows2(fkeys, trkeys, bound=pcap)
    own1 = (fid1.clamp(min=0) // 4).long()
    own2 = (fid2.clamp(min=0) // 4).long()
    tria_int = _i32(torch.cat([
        take(m.vglob, m.tria), m.trref[:, None],
        # strip only the interface-position bits; NOSURF stays with the
        # REQUIRED it marks as split-added
        (m.trtag & ~(tags.PARBDY | tags.PARBDYBDY))[:, None]], 1))
    buf_fi = torch.full((d, tria_cap, 5), -1, dtype=torch.int32,
                        device=dev)
    for dst in range(d):
        d1 = (cnt >= 1) & out_s[own1] & (color_s[own1] == dst)
        d2 = (cnt >= 2) & out_s[own2] & (color_s[own2] == dst)
        sel = real_tr & (d1 | d2)
        n_f[dst] = sel.sum()
        buf_fi[dst] = _slots(buf_fi[dst], sel, tria_int)
    # a tria stays iff some owner stays; pure synthetic interface trias
    # are dropped here and recreated by retag_interfaces where needed
    keep1 = (cnt >= 1) & ~out_s[own1]
    keep2 = (cnt >= 2) & ~out_s[own2]
    tria_keep = m.trmask & ~syn & (keep1 | keep2 | (cnt == 0))
    # --- feature edges ----------------------------------------------------
    ed_int = _i32(torch.cat([take(m.vglob, m.edge), m.edref[:, None],
                             m.edtag[:, None]], 1))
    buf_ei = torch.full((d, edge_cap, 4), -1, dtype=torch.int32,
                        device=dev)

    def touched(tsel):
        idx = torch.where(tsel[:, None], m.tet, pcap).reshape(-1)
        return scatter(torch.zeros(pcap, dtype=torch.bool, device=dev),
                       idx, True)

    e0, e1 = m.edge[:, 0], m.edge[:, 1]
    for dst in range(d):
        vd = touched(out_s & (color_s == dst))
        sel = m.edmask & take(vd, e0) & take(vd, e1)
        n_e[dst] = sel.sum()
        buf_ei[dst] = _slots(buf_ei[dst], sel, ed_int)
    # edges stay only where both endpoints still belong to a staying tet
    stay_v = touched(m.tmask & ~out_s)
    edge_keep = m.edmask & take(stay_v, e0) & take(stay_v, e1)
    counts = torch.stack([torch.stack(n) for n in (n_t, n_f, n_e)])
    return (buf_ti, buf_tf, buf_fi, buf_ei, tria_keep, edge_keep,
            _i32(counts))


def _pack(stacked: Mesh, color: torch.Tensor, slot_cap: int,
          tria_cap: int, edge_cap: int):
    """Per-destination slot buffers of every shard, stacked on a leading
    source axis: ((ti [D,D,cap,13], tf [D,D,cap,4,Wf], fi, ei, tria_keep,
    edge_keep, counts [D,3,D]), outgoing tets [D,T])."""
    out_t = _outgoing(stacked, color)
    d = color.shape[0]
    parts = [_pack_shard(m, out_t[s], color[s], d, slot_cap, tria_cap,
                         edge_cap)
             for s, m in enumerate(unstack_mesh(stacked))]
    return tuple(torch.stack(x) for x in zip(*parts)), out_t


def _exchange(buf: torch.Tensor) -> torch.Tensor:
    """[D_src, D_dst, ...] -> [D_dst, D_src, ...]."""
    return buf.transpose(0, 1).contiguous()


def _first_rows(q):
    """[R] bool: first occurrence of each valid (column 0 >= 0) sorted
    row of `q` in lexicographic order."""
    order = common.lexsort([q[:, c] for c in reversed(range(q.shape[1]))])
    sq = q[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=q.device),
                       torch.any(sq[1:] != sq[:-1], dim=1)]) & (sq[:, 0] >= 0)
    return scatter(torch.zeros(q.shape[0], dtype=torch.bool,
                               device=q.device), order, first)


def _integrate_shard(m: Mesh, out_s, ti, tf, fi, ei, tr_keep, ed_keep):
    """Receive-side merge on one shard: dedup incoming vertices by gid
    against the shard's, append new vertices, tets, trias and edges
    after the live prefixes, drop the outgoing tets. Returns (mesh,
    overflow [4] of verts/tets/trias/edges beyond the capacities)."""
    dev = m.device
    pcap, tcap, fcap, ecap = m.pcap, m.tcap, m.fcap, m.ecap
    ti = ti.reshape(-1, ti.shape[-1])                       # [K,13]
    tf = tf.reshape(-1, 4, tf.shape[-1])                    # [K,4,Wf]
    fi = fi.reshape(-1, fi.shape[-1])                       # [Kf,5]
    ei = ei.reshape(-1, ei.shape[-1])                       # [Ke,4]
    k = ti.shape[0]
    t_valid = ti[:, 0] >= 0

    # ---- vertices: dedup corners by gid, match against the local ones --
    cg = torch.where(t_valid[:, None], ti[:, :4], -1).reshape(-1)  # [4K]
    ckey = torch.where(cg >= 0, cg, 2**30)
    order = torch.argsort(ckey, stable=True)
    sg = ckey[order]
    newg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      sg[1:] != sg[:-1]])
    live_s = sg < 2**30
    uid = _cumrank(newg)                                    # group id
    rep_sorted = newg & live_s
    lkeys = torch.where(m.vmask, m.vglob, -1)[:, None]
    q = torch.where(rep_sorted, sg, -1)[:, None]
    loc = common.match_rows(lkeys, q).to(torch.int64)
    isnew_rep = rep_sorted & (loc < 0)
    np0 = m.npoin
    slot_rep = torch.where(isnew_rep, np0 + _cumrank(isnew_rep), loc)
    gslot = scatter(torch.full((4 * k,), -1, dtype=torch.int64, device=dev),
                    torch.where(rep_sorted, uid, 4 * k), slot_rep, "max")
    corner_slot = scatter(torch.full((4 * k,), -1, dtype=torch.int64,
                                     device=dev), order, gslot[uid])
    # payloads of the new vertices (one writer: the representative)
    wnew = scatter(torch.zeros(4 * k, dtype=torch.bool, device=dev), order,
                   isnew_rep)
    tgt_v = unique_oob(wnew, corner_slot, pcap)
    fpay = tf.reshape(-1, tf.shape[-1])                     # [4K,Wf]
    widths = [m.vert.shape[1], m.met.shape[1], m.ls.shape[1],
              m.disp.shape[1], m.fields.shape[1]]
    cols = np.cumsum([0] + widths)
    vert, met, ls, disp, fields = (
        scatter(getattr(m, name), tgt_v, fpay[:, cols[i]:cols[i + 1]])
        for i, name in enumerate(("vert", "met", "ls", "disp", "fields")))
    vtag = scatter(m.vtag, tgt_v, ti[:, 5:9].reshape(-1))
    vref = scatter(m.vref, tgt_v, ti[:, 9:13].reshape(-1))
    vglob = scatter(m.vglob, tgt_v, ti[:, :4].reshape(-1))
    vmask = scatter(m.vmask, tgt_v, True)

    # ---- tets ----------------------------------------------------------
    ne0 = m.ntet
    tgt_t = unique_oob(t_valid, ne0 + _cumrank(t_valid), tcap)
    tet = scatter(m.tet, tgt_t, corner_slot.reshape(k, 4))
    tref = scatter(m.tref, tgt_t, ti[:, 4])
    tmask = scatter(m.tmask & ~out_s, tgt_t, t_valid)

    live_g = torch.where(vmask, vglob, -1)[:, None]

    def append(keep, conn, conn_in, extras, n0, cap):
        """Dedup incoming rows (gid tuples) against the kept local rows
        and among themselves (first occurrence wins), map their gids to
        local slots and append them after the live prefix."""
        valid = conn_in[:, 0] >= 0
        w = conn.shape[1]
        loc_rows = torch.sort(torch.where(keep[:, None], take(m.vglob, conn),
                                          -1), dim=1).values
        q_rows = torch.sort(torch.where(valid[:, None], conn_in[:, :w], -1),
                            dim=1).values
        dup = common.sorted_membership(loc_rows, q_rows)
        add = valid & _first_rows(q_rows) & ~dup
        slot = common.match_rows(
            live_g, torch.where(add[:, None], conn_in[:, :w], -1).reshape(
                -1, 1)).reshape(-1, w)
        add = add & torch.all(slot >= 0, dim=1)
        tgt = unique_oob(add, n0 + _cumrank(add), cap)
        return (scatter(conn, tgt, slot),
                [scatter(e, tgt, conn_in[:, w + i])
                 for i, e in enumerate(extras)],
                scatter(keep, tgt, add), add.sum())

    # ---- trias and feature edges: kept rows stay in place (mask only),
    # appends go after the pre-migration live prefix --------------------
    nf0, ned0 = m.ntria, m.nedge
    tria, (trref, trtag), trmask, nf_add = append(
        tr_keep, m.tria, fi, (m.trref, m.trtag), nf0, fcap)
    edge, (edref, edtag), edmask, ne_add = append(
        ed_keep, m.edge, ei, (m.edref, m.edtag), ned0, ecap)

    # appended entities beyond the capacities were dropped by the
    # scatters above: the caller is told
    overflow = torch.stack([np0 + wnew.sum() - pcap,
                            ne0 + t_valid.sum() - tcap,
                            nf0 + nf_add - fcap, ned0 + ne_add - ecap])
    return m.replace(
        vert=vert, met=met, ls=ls, disp=disp, fields=fields, vtag=vtag,
        vref=vref, vglob=vglob, vmask=vmask, tet=tet, tref=tref,
        tmask=tmask, tria=tria, trref=trref, trtag=trtag, trmask=trmask,
        edge=edge, edref=edref, edtag=edtag, edmask=edmask), overflow


def migrate(stacked: Mesh, color: torch.Tensor, nparts: int,
            slot_cap: int) -> Mesh:
    """Move tets to their `color` shard through the fixed-slot exchange.
    `slot_cap` must hold the largest outgoing count per (source,
    destination) pair (`migration_counts`) and the capacities must have
    room for the incoming entities; otherwise `CapacityError` carries
    the pack-side counts and caps, or the per-shard overflow."""
    tria_cap = slot_cap + 8
    edge_cap = max(slot_cap // 2, 64)
    (bti, btf, bfi, bei, tria_keep, edge_keep, pack_n), out_t = _pack(
        stacked, color, slot_cap, tria_cap, edge_cap)
    # a slot cap that undershoots would drop outgoing entities: check the
    # true per-destination counts before anything is applied
    pn = pack_n.cpu().numpy()                   # [D, 3(kind), D(dst)]
    caps = np.asarray([slot_cap, tria_cap, edge_cap])
    if (pn > caps[None, :, None]).any():
        raise CapacityError(
            "migration slot capacities too small (per-source max "
            f"[tets,trias,edges]: {pn.max(axis=(0, 2)).tolist()} vs caps "
            f"{caps.tolist()}) — raise slot_cap",
            counts=pn, caps=caps)
    rti, rtf, rfi, rei = (_exchange(b) for b in (bti, btf, bfi, bei))
    shards, over = [], []
    for s, m in enumerate(unstack_mesh(stacked)):
        got, o = _integrate_shard(m, out_t[s], rti[s], rtf[s], rfi[s],
                                  rei[s], tria_keep[s], edge_keep[s])
        shards.append(got)
        over.append(o)
    over = torch.stack(over).cpu().numpy()
    if (over > 0).any():
        raise CapacityError(
            "migration overflowed shard capacities "
            f"(excess per shard [verts,tets,trias,edges]: {over.tolist()})"
            " — grow the stacked mesh before migrating",
            overflow=over)
    return stack_meshes(shards)


# ---------------------------------------------------------------------------
# interface re-tagging
# ---------------------------------------------------------------------------

_IFC_TAG = tags.PARBDY | tags.REQUIRED | tags.NOSURF | tags.BDY


def _retag_shard_trias(vglob_s, vmask_s, tria_s, trtag_s, trref_s,
                       trmask_s, prow_s, ifc_s, first_s, G: int):
    """One shard's synthetic-tria bookkeeping: drop stale synthetic
    trias, refresh the interface bits of real ones, append the missing
    first-copy interface faces into free slots. Returns (tria, trtag,
    trref, trmask, n_missing, n_free)."""
    dev = vglob_s.device
    PC, FC = vglob_s.shape[0], tria_s.shape[0]
    fcapq = prow_s.shape[0]
    t_rows = torch.where(trmask_s[:, None],
                         torch.sort(take(vglob_s, tria_s), dim=1).values, -1)
    keys = torch.where(ifc_s[:, None], prow_s, -1)
    member = common.sorted_membership(keys, t_rows)
    syn = tags.pure_interface_tria(trtag_s) & trmask_s
    trmask2 = trmask_s & ~(syn & ~member)                  # stale drop
    real = trmask2 & ~syn
    at_ifc = real & member
    tt = torch.where(at_ifc,
                     trtag_s | (tags.PARBDY | tags.PARBDYBDY | tags.BDY),
                     trtag_s)
    fresh_noreq = at_ifc & ((trtag_s & tags.REQUIRED) == 0)
    tt = torch.where(fresh_noreq, tt | (tags.REQUIRED | tags.NOSURF), tt)
    clear = real & ~member & ((trtag_s & tags.PARBDYBDY) != 0)
    tt = torch.where(clear, tt & ~(tags.PARBDY | tags.PARBDYBDY), tt)
    syn_req = clear & ((tt & tags.NOSURF) != 0)
    tt = torch.where(syn_req, tt & ~(tags.REQUIRED | tags.NOSURF), tt)
    # missing: first-copy interface faces with no live tria
    live_rows = torch.where(trmask2[:, None], t_rows, -1)
    have = common.sorted_membership(
        live_rows, torch.where(first_s[:, None], prow_s, -1))
    missing = first_s & ~have
    # gid -> local slot through the shard's sorted gid table
    gkey = torch.where(vmask_s, vglob_s, G)
    order_v = torch.argsort(gkey, stable=True)
    sg = gkey[order_v].contiguous()
    pos = torch.searchsorted(
        sg, prow_s.clamp(min=0).reshape(-1).contiguous()).clamp(0, PC - 1)
    slot = order_v[pos].reshape(fcapq, 3)
    free = ~trmask2
    free_list = torch.argsort(
        torch.where(free, torch.arange(FC, device=dev), FC), stable=True)
    rank = _cumrank(missing)
    tgt = unique_oob(missing, free_list[rank.clamp(0, FC - 1)], FC)
    return (scatter(tria_s, tgt, slot.to(tria_s.dtype)),
            scatter(tt, tgt, _IFC_TAG), scatter(trref_s, tgt, 0),
            scatter(trmask2, tgt, True), missing.sum(), free.sum())


def _retag_device_core(stacked: Mesh, fcapq: int):
    """Interface retagging on the device:

    1. PARBDY vertex bits from global gid multiplicity (a histogram over
       the gid space);
    2. each shard's open faces (compacted to `fcapq` rows) keyed by
       sorted gid triples, their multiplicity over all shards from one
       sort of all shards' rows;
    3. per shard, the synthetic-tria bookkeeping;
    4. PARBDYBDY vertex bits.

    Returns (vtag, tria, trref, trtag, trmask, n_open, n_missing,
    n_free), the last three per shard."""
    D, PC = stacked.vglob.shape
    TC = stacked.tet.shape[1]
    dev = stacked.device
    vglob = _i32(stacked.vglob)
    vmask, tmask = stacked.vmask, stacked.tmask
    G = D * PC  # exclusive gid bound
    adja = stacked_adjacency(stacked).adja

    # --- 1. PARBDY from gid multiplicity ------------------------------
    gidx = torch.where(vmask, vglob, G)
    mult = scatter(torch.zeros(G, dtype=torch.int32, device=dev),
                   gidx.reshape(-1), 1, "add")
    shared = vmask & (take(mult, vglob.clamp(0, G - 1).reshape(-1))
                      .reshape(D, PC) > 1)
    vtag = torch.where(shared, stacked.vtag | tags.PARBDY,
                       stacked.vtag & ~(tags.PARBDY | tags.PARBDYBDY))

    # --- 2. open faces -> cross-shard interface faces -----------------
    fv = torch.as_tensor(FACE_VERTS, dtype=torch.int64, device=dev)
    corners = stacked.tet.long()[:, :, fv]                 # [D,TC,4,3]
    vg = torch.stack([take(vglob[s], corners[s]) for s in range(D)])
    g3 = torch.sort(vg, dim=-1).values.reshape(D, 4 * TC, 3)
    openf = ((adja < 0) & tmask[:, :, None]).reshape(D, 4 * TC)
    n_open = openf.sum(dim=1)
    # compact to fcapq rows, keeping the enumeration order
    ar = torch.arange(4 * TC, device=dev)
    pick = torch.argsort(torch.where(openf, ar, 4 * TC), dim=1,
                         stable=True)[:, :fcapq]
    pvalid = torch.gather(openf, 1, pick)
    prow = torch.gather(g3, 1, pick[:, :, None].expand(D, fcapq, 3))
    prow = torch.where(pvalid[..., None], prow, -1)

    allr = prow.reshape(D * fcapq, 3)
    invalid = torch.any(allr < 0, dim=1)
    order, newgrp = common._row_order_groups(allr, invalid, None)
    cnt_sorted = common.seg_broadcast(_i32(~invalid[order]), newgrp, "add",
                                      0)
    cnt = scatter(torch.zeros(D * fcapq, dtype=torch.int32, device=dev),
                  order, cnt_sorted)
    is_ifc = (~invalid & (cnt > 1)).reshape(D, fcapq)
    # within-shard duplicate face rows: only the first copy may
    # materialize a synthetic tria
    ar_q = torch.arange(fcapq, dtype=torch.int32, device=dev)
    first = torch.stack([common.match_rows(p, p) == ar_q for p in prow]) \
        & is_ifc

    # --- 3. per-shard synthetic-tria bookkeeping ----------------------
    parts = [_retag_shard_trias(vglob[s], vmask[s], stacked.tria[s],
                                stacked.trtag[s], stacked.trref[s],
                                stacked.trmask[s], prow[s], is_ifc[s],
                                first[s], G)
             for s in range(D)]
    tria, trtag, trref, trmask, n_missing, n_free = (
        torch.stack(x) for x in zip(*parts))

    # --- 4. PARBDYBDY vertex bits -------------------------------------
    both = ((vtag & tags.PARBDY) != 0) & ((vtag & tags.BDY) != 0)
    vtag = torch.where(both, vtag | tags.PARBDYBDY, vtag)
    return vtag, tria, trref, trtag, trmask, n_open, n_missing, n_free


def retag_interfaces(stacked: Mesh, icap=None) -> Tuple[Mesh, ShardComm]:
    """Recompute the parallel-interface discipline after a migration
    (`_retag_device_core`) and the node tables; the host reads only the
    per-shard counts that size and check the capacities."""
    TC = stacked.tet.shape[1]
    fcapq = min(4 * TC, max(2048, TC))  # 4*TC = exact upper bound
    for _ in range(2):
        (vtag, tria, trref, trtag, trmask,
         n_open, n_missing, n_free) = _retag_device_core(stacked, fcapq)
        if int(n_open.max()) <= fcapq:
            break
        fcapq = 4 * TC  # every tet face open
    miss, free = n_missing.cpu().numpy(), n_free.cpu().numpy()
    over = miss > free
    if over.any():
        z = np.zeros_like(miss)
        raise CapacityError(
            "tria capacity too small for interface trias "
            f"(shards {np.nonzero(over)[0].tolist()})",
            overflow=np.stack([z, z, miss - free, z], axis=1))
    stacked = stacked.replace(vtag=vtag, tria=tria, trref=trref,
                              trtag=trtag, trmask=trmask)
    return stacked, rebuild_comm(stacked, icap)


# ---------------------------------------------------------------------------
# frontier remap through the exchange
#
# The active-set carry must survive the migration: vertex identity across
# the exchange is the persistent global id, so the set is encoded as gid
# keys before the exchange and decoded per shard after it.
# ---------------------------------------------------------------------------

def migrating_vertices(stacked: Mesh, color: torch.Tensor) -> torch.Tensor:
    """[D, PC] bool: vertices of tets about to leave their shard."""
    pc = stacked.vmask.shape[1]
    leaving = _outgoing(stacked, color)
    out = []
    for s in range(color.shape[0]):
        idx = torch.where(leaving[s][:, None], stacked.tet[s], pc)
        out.append(scatter(torch.zeros(pc, dtype=torch.bool,
                                       device=color.device),
                           idx.reshape(-1), True))
    return torch.stack(out)


def frontier_gid_keys(stacked: Mesh, sel: torch.Tensor) -> torch.Tensor:
    """[D*PC, 1] int32 gid rows of the selected live vertices (-1 rows
    never match); global ids must be assigned."""
    g = torch.where(sel & stacked.vmask, stacked.vglob, -1)
    return _i32(g.reshape(-1, 1))


def frontier_from_gid_keys(stacked: Mesh, keys: torch.Tensor) -> torch.Tensor:
    """[D, PC] bool: live vertices whose gid is among `keys`."""
    q = _i32(torch.where(stacked.vmask, stacked.vglob, -1).reshape(-1, 1))
    hit = common.sorted_membership(keys, q)
    return hit.reshape(stacked.vmask.shape) & stacked.vmask
