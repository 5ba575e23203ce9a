"""Shared primitives for the batched remeshing operators.

Counterpart of `parmmg_tpu/ops/common.py`. Operators are applied in
parallel Jacobi sweeps over *independent sets*: every candidate operation
claims an arena of tets and only the best-priority candidate per arena
survives. These helpers implement that selection, the sort-based set
matching the operators need, and the scatter/gather conventions the JAX
package relies on:

- a JAX gather clamps out-of-range indices (after wrapping negative ones
  once); `take` reproduces that, so garbage rows that are masked later
  never raise on the GPU;
- a JAX ``mode="drop"`` scatter wraps negative indices once and drops
  what is still out of range; `scatter` sends those rows to a dump slot
  one past the end and slices it off, which needs no host sync.

Sorts use `torch.argsort(stable=True)`; a lexicographic sort is a chain
of stable sorts from the least to the most significant key, with columns
packed into int64 keys where they fit.
"""

from __future__ import annotations

import math

import torch

from ..core.mesh import EDGE_VERTS, Mesh
from ..kernels.quality_k import vol_of  # noqa: F401  (re-export)

# positivity floor for tentative configurations: a new/retargeted/moved
# tet must keep at least this fraction of its local reference volume
POS_VOL_FRAC = 1e-4

# tie-break hash multiplier of the independent-set selections
_HASH_MUL = 2654435761


def vol_tols(dtype):
    """(positivity fraction, conservation tolerance) for volume
    predicates; only the conservation tolerance scales with the dtype's
    epsilon."""
    eps = float(torch.finfo(dtype).eps)
    return POS_VOL_FRAC, max(1e-9, 256.0 * eps)


# ---------------------------------------------------------------------------
# gather / scatter with the JAX index conventions
# ---------------------------------------------------------------------------


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`a[idx]` with JAX gather semantics: negative indices wrap once,
    the rest is clamped into range."""
    n = a.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, max(n - 1, 0))
    return a[idx]


# dump slots past the end of a scatter's target: dropped rows spread over
# them, so no single slot collects the updates of every masked row
_DUMP = 1024


def _drop_idx(idx: torch.Tensor, n: int):
    """Scatter targets with ``mode="drop"`` semantics: negative indices
    wrap once; whatever is still out of range goes to a dump slot in
    [n, n + _DUMP). Returns (targets, each row's dump slot)."""
    idx = idx.reshape(-1).long()
    idx = torch.where(idx < 0, idx + n, idx)
    dump = n + torch.arange(idx.shape[0], device=idx.device) % _DUMP
    return torch.where((idx >= 0) & (idx < n), idx, dump), dump


def scatter(dst: torch.Tensor, idx: torch.Tensor, vals, op: str = "set"):
    """`dst.at[idx].<op>(vals, mode="drop")` along the leading axis; `op`
    is one of set/add/min/max. Returns a new tensor."""
    n = dst.shape[0]
    row = dst.shape[1:]
    if 0 in row:
        return dst
    i, dump = _drop_idx(idx, n)
    vals = torch.as_tensor(vals, dtype=dst.dtype, device=dst.device)
    vals = vals.reshape((-1,) + tuple(row)) if vals.dim() > len(row) \
        else vals
    vals = vals.expand((i.shape[0],) + tuple(row))
    buf = dst.new_empty((n + _DUMP,) + tuple(row))
    buf[:n] = dst
    if dst.dtype == torch.bool and op in ("min", "max"):
        # bool max = OR of the True updates, min = AND of the False ones
        keep = vals if op == "max" else ~vals
        if keep.dim() > 1:
            raise ValueError("bool min/max scatters take 1-D rows only")
        buf[torch.where(keep, i, dump)] = op == "max"
        return buf[:n]
    if op == "set":
        buf[i] = vals
        return buf[:n]
    if op not in ("add", "min", "max"):
        raise ValueError(f"unknown scatter op {op!r}")
    if buf.is_cuda:
        # updates that cannot change their slot (adding zero, min with
        # +inf, max with -inf — masked rows, which often all name one
        # slot) go to the dump: on the GPU, thousands of updates of one
        # slot serialize
        ident = {"add": 0, "min": math.inf, "max": -math.inf}[op]
        noop = (vals == ident).reshape(i.shape[0], -1).all(dim=1)
        i = torch.where(noop, dump, i)
    if op == "add" and buf.is_cuda and buf.is_floating_point():
        # float atomics would sum in arrival order, so a run could not be
        # repeated bit for bit: sort the updates by slot and reduce each
        # slot's run in a fixed order instead
        order = torch.argsort(i, stable=True)
        si = i[order]
        sums = torch.segment_reduce(
            vals[order], "sum", axis=0, unsafe=True,
            lengths=torch.bincount(si, minlength=buf.shape[0]))
        buf += sums
    elif op == "add":
        buf.index_add_(0, i, vals)
    else:
        ii = i.reshape((-1,) + (1,) * len(row)).expand_as(vals)
        buf.scatter_reduce_(0, ii, vals, "amin" if op == "min" else "amax",
                            include_self=True)
    return buf[:n]


def unique_oob(sel, target, cap):
    """Scatter index vector: `target` where `sel`, else a distinct
    out-of-bounds value (cap + position)."""
    n = target.shape[0]
    return torch.where(
        sel, target.to(torch.int64),
        cap + torch.arange(n, dtype=torch.int64, device=target.device),
    )


def seg_broadcast(vals, newgrp, op: str, neutral):
    """Per-element reduction of `op` (add/min/max) over the element's
    group, where groups are contiguous runs of a sorted domain flagged by
    `newgrp` (run starts): `full(neutral).at[gid].op(vals)[gid]`."""
    n = vals.shape[0]
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    acc = torch.full((n,), neutral, dtype=vals.dtype, device=vals.device)
    acc = scatter(acc, gid, vals, op)
    return acc[gid]


def seg_broadcast_or(vals, newgrp, bits):
    """Group bitwise OR of int tag fields, one max-reduction per bit in
    `bits` (the tag bits that can occur in `vals`)."""
    out = torch.zeros_like(vals)
    for bit in bits:
        has = seg_broadcast(((vals & bit) != 0).to(torch.int32), newgrp,
                            "max", 0)
        out = out | torch.where(has > 0, bit, 0).to(vals.dtype)
    return out


# ---------------------------------------------------------------------------
# sorting
# ---------------------------------------------------------------------------


def lexsort(keys) -> torch.Tensor:
    """numpy/JAX `lexsort`: the LAST key is the primary one; stable."""
    keys = list(keys)
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _bits_for(bound) -> int:
    b = (1 << 31) if bound is None else int(bound) + 2
    return max(1, math.ceil(math.log2(b)))


def _pack_cols(cols, bound):
    """int64 sort keys (most significant first) from nonnegative int
    columns: adjacent columns share one key where their bit widths fit.

    This is the port's one packing rule, in place of the JAX package's
    `pack_ok`/`_pack_pairs` (uint32 pairs for ids below 65534): a
    packed key orders rows exactly as the columns do, so both rules give
    the same stable sort order and only the key width differs."""
    bits = _bits_for(bound)
    per = max(1, 62 // bits)
    keys = []
    for s in range(0, len(cols), per):
        k = cols[s].to(torch.int64)
        for c in cols[s + 1: s + per]:
            k = (k << bits) | c.to(torch.int64)
        keys.append(k)
    return keys


_SENT = (1 << 62)


def _row_order_groups(rows, invalid, bound):
    """Sort rows lexicographically (column 0 most significant) and mark
    group starts. Invalid rows share one trailing sentinel group; every
    consumer masks them out. Returns (order, newgrp)."""
    cols = [rows[:, i].clamp(min=0) for i in range(rows.shape[1])]
    keys = [torch.where(invalid, _SENT, k) for k in _pack_cols(cols, bound)]
    order = lexsort(list(reversed(keys)))
    sk = [k[order] for k in keys]
    diff = sk[0][1:] != sk[0][:-1]
    for k in sk[1:]:
        diff = diff | (k[1:] != k[:-1])
    newgrp = torch.cat([torch.ones(1, dtype=torch.bool, device=rows.device),
                        diff])
    return order, newgrp


def sorted_pair_groups(lo, hi, dead, bound, dead_slot=None):
    """Sort (lo,hi) pairs and mark group starts — the shared core of
    `unique_edges` and feature-edge detection. Returns (order, newgrp,
    live_sorted, slo, shi); dead rows form one trailing group that never
    becomes a representative, and slo/shi are garbage on them."""
    bits = _bits_for(bound)
    key = (lo.clamp(min=0).to(torch.int64) << bits) | hi.clamp(min=0).to(
        torch.int64)
    key = torch.where(dead, _SENT, key)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    newgrp = torch.cat([torch.ones(1, dtype=torch.bool, device=lo.device),
                        sk[1:] != sk[:-1]])
    live_sorted = sk != _SENT
    return order, newgrp, live_sorted, lo[order], hi[order]


def _run_match(keys, query, bound=None):
    """Sort-merge row matching: (hit [Q] bool, first matching key index
    [Q] or -1). Rows with any negative entry never match."""
    k = keys.shape[0]
    n = k + query.shape[0]
    rows = torch.cat([keys, query], 0).to(torch.int32)
    invalid = torch.any(rows < 0, dim=1)
    order, newgrp = _row_order_groups(rows, invalid, bound)
    from_key = order < k
    cnt_b = seg_broadcast(from_key.to(torch.int32), newgrp, "add", 0)
    min_b = seg_broadcast(torch.where(from_key, order, n), newgrp, "min", n)
    hit_sorted = cnt_b > 0
    idx_sorted = torch.where(hit_sorted, min_b, -1)
    hit = torch.zeros(n, dtype=torch.bool, device=rows.device)
    hit[order] = hit_sorted
    idx = torch.full((n,), -1, dtype=torch.int64, device=rows.device)
    idx[order] = idx_sorted
    return (hit[k:] & ~invalid[k:],
            torch.where(invalid[k:], -1, idx[k:]).to(torch.int32))


def match_rows2(keys, query, bound=None):
    """(first_idx, last_idx, count) of each query row among `keys`: like
    `_run_match`, with the last matching key index and the match count."""
    k = keys.shape[0]
    n = k + query.shape[0]
    rows = torch.cat([keys, query], 0).to(torch.int32)
    invalid = torch.any(rows < 0, dim=1)
    order, newgrp = _row_order_groups(rows, invalid, bound)
    from_key = order < k
    cnt_sorted = seg_broadcast(from_key.to(torch.int32), newgrp, "add", 0)
    minidx = seg_broadcast(torch.where(from_key, order, n), newgrp, "min", n)
    maxidx = seg_broadcast(torch.where(from_key, order, -1), newgrp, "max",
                           -1)
    lo = torch.where(cnt_sorted > 0, minidx, -1)
    hi = torch.where(cnt_sorted > 0, maxidx, -1)
    dev = rows.device
    out_lo = torch.full((n,), -1, dtype=torch.int64, device=dev)
    out_hi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    out_cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    out_lo[order] = lo
    out_hi[order] = hi
    out_cnt[order] = cnt_sorted
    out_lo = torch.where(invalid, -1, out_lo).to(torch.int32)
    out_hi = torch.where(invalid, -1, out_hi).to(torch.int32)
    out_cnt = torch.where(invalid, 0, out_cnt)
    return out_lo[k:], out_hi[k:], out_cnt[k:]


def sorted_membership(keys, query, bound=None):
    """[Q] bool: does each query row appear among `keys` rows?"""
    hit, _ = _run_match(keys, query, bound)
    return hit


def match_rows(keys, query, bound=None):
    """[Q] int32 index of the first row of `keys` equal to each query
    row, -1 if absent."""
    _, idx = _run_match(keys, query, bound)
    return idx


def duplicate_tets(tet, valid, bound=None):
    """[T] bool: the tet's sorted vertex set appears more than once among
    valid tets (the batched link-condition stand-in)."""
    keys = torch.sort(tet, dim=1).values
    cols = [keys[:, i].clamp(min=0) for i in range(4)]
    packed = [torch.where(valid, k, _SENT) for k in _pack_cols(cols, bound)]
    order = lexsort(list(reversed(packed)))
    sk = [k[order] for k in packed]
    vs = valid[order]
    same = vs[:-1] & vs[1:]
    for k in sk:
        same = same & (k[:-1] == k[1:])
    f = torch.zeros(1, dtype=torch.bool, device=tet.device)
    same_next = torch.cat([same, f])
    same_prev = torch.cat([f, same])
    out = torch.zeros_like(valid)
    out[order] = same_next | same_prev
    return out & valid


# ---------------------------------------------------------------------------
# independent-set selection
# ---------------------------------------------------------------------------


def _hash(n: int, device, mask: int = 0xFFFFFF) -> torch.Tensor:
    """`idx * 2654435761` in uint32, masked — computed in int64 (the low
    32 bits of the product are what uint32 arithmetic keeps)."""
    return (torch.arange(n, dtype=torch.int64, device=device) * _HASH_MUL) \
        & mask


def two_phase_winners(prio, cand, scatter_arena, gather_arena):
    """Independent-set selection with exact tie-breaking: max priority per
    arena cell, float ties broken by a hashed candidate index."""
    n = prio.shape[0]
    p = torch.where(cand, prio, -math.inf)
    best = gather_arena(scatter_arena(p))
    is_top = cand & (p >= best) & torch.isfinite(p)
    neg1 = torch.tensor(-1.0, dtype=torch.float32, device=prio.device)
    if n <= (1 << 24):
        h = _hash(n, prio.device).to(torch.float32)
        best_h = gather_arena(scatter_arena(torch.where(is_top, h, neg1)))
        return is_top & (h >= best_h)
    idx = _hash(n, prio.device, 0xFFFFFFFF)
    hi = (idx >> 16).to(torch.float32)
    best_hi = gather_arena(scatter_arena(torch.where(is_top, hi, neg1)))
    is_top = is_top & (hi >= best_hi)
    lo = (idx & 0xFFFF).to(torch.float32)
    best_lo = gather_arena(scatter_arena(torch.where(is_top, lo, neg1)))
    return is_top & (lo >= best_lo)


def rank_winners(prio, cand, scatter_arena, gather_arena):
    """Independent-set selection in one arena propagation: the
    (priority, hashed id) order as a unique f32-exact rank; a candidate
    wins iff its rank is the max in every arena cell it touches."""
    n = prio.shape[0]
    if n > (1 << 24):
        return two_phase_winners(prio, cand, scatter_arena, gather_arena)
    h24 = _hash(n, prio.device)
    p = torch.where(cand, prio, -math.inf)
    order = lexsort((h24, p))
    rank = torch.zeros(n, dtype=torch.int32, device=prio.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=prio.device)
    r = torch.where(cand, rank.to(torch.float32), -math.inf)
    best = gather_arena(scatter_arena(r))
    return cand & (r >= best) & torch.isfinite(r)


# ---------------------------------------------------------------------------
# frontier (active-set) helpers
#
# Every sweep records the vertices whose geometry or 1-ring topology it
# changed (`changed_v` in the operators' stats); the next sweep's
# candidates are gated on the one-ring closure of that set. The all-true
# mask reproduces the full-table sweep bit for bit.
# ---------------------------------------------------------------------------


def one_ring_closure(tet, tmask, changed_v):
    """[PC] bool: vertices sharing a valid tet with a changed vertex,
    the changed vertices included."""
    pcap = changed_v.shape[0]
    t_hot = torch.any(take(changed_v, tet), dim=1) & tmask
    idx = torch.where(t_hot[:, None], tet, pcap).reshape(-1)
    av = scatter(torch.zeros(pcap, dtype=torch.bool,
                             device=changed_v.device), idx, True)
    return av | changed_v


def edge_active(active_v, a, b, emask):
    """[E] bool: unique edge with an endpoint in the active closure."""
    return emask & (take(active_v, a) | take(active_v, b))


def topk_candidates(cand, sortkey, K: int):
    """The K lowest-`sortkey` rows among `cand` (non-candidates sort to
    +inf): (pick [K] int64 row ids, valid [K] bool)."""
    key = torch.where(cand, sortkey, math.inf)
    pick = torch.argsort(key, stable=True)[:K]
    return pick, cand[pick]


# ---------------------------------------------------------------------------
# mesh-level matching helpers
# ---------------------------------------------------------------------------


def tria_edge_keys(mesh: Mesh, mask=None):
    """[3*FC, 2] sorted (lo,hi) vertex pairs of tria edges (order 01, 12,
    02); excluded trias give (-1,-1) rows."""
    t = mesh.tria
    pairs = torch.stack([t[:, [0, 1]], t[:, [1, 2]], t[:, [0, 2]]], dim=1)
    lo = torch.minimum(pairs[..., 0], pairs[..., 1])
    hi = torch.maximum(pairs[..., 0], pairs[..., 1])
    dead = ~(mesh.trmask if mask is None else mask)[:, None]
    lo = torch.where(dead, -1, lo).reshape(-1)
    hi = torch.where(dead, -1, hi).reshape(-1)
    return torch.stack([lo, hi], dim=1)


def surface_edge_mask(mesh: Mesh, edges, emask):
    """[E] bool: edge lies on the boundary surface (in a valid tria)."""
    keys = tria_edge_keys(mesh)
    q = torch.where(emask[:, None], edges, -1)
    return sorted_membership(keys, q, bound=mesh.pcap)


def feature_edge_index(mesh: Mesh, edges, emask):
    """[E] int32 index into mesh.edge of the feature edge matching each
    unique tet edge (-1 if none)."""
    lo = torch.minimum(mesh.edge[:, 0], mesh.edge[:, 1])
    hi = torch.maximum(mesh.edge[:, 0], mesh.edge[:, 1])
    dead = ~mesh.edmask
    keys = torch.stack([torch.where(dead, -1, lo),
                        torch.where(dead, -1, hi)], dim=1)
    q = torch.where(emask[:, None], edges, -1)
    return match_rows(keys, q, bound=mesh.pcap)


def edge_verts_t(device) -> torch.Tensor:
    """EDGE_VERTS as an int64 tensor on `device`."""
    return torch.as_tensor(EDGE_VERTS, dtype=torch.int64, device=device)
