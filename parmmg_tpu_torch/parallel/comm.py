"""Halo exchange over the node-communicator tables of a stacked mesh.

Counterpart of `parmmg_tpu/parallel/comm.py`. There each function runs
inside `shard_map` on one shard and the exchange is an `all_to_all`
over the shard axis; here every shard lives in one stacked tensor on one
device, so the exchange is an index gather across the shard axis and the
combine a scatter per shard. `vals` is [D, P, ...] and `comm_idx` the
`ShardComm`'s [D, D, I] table (`comm_idx[s, r, k]`: the slot, in shard
s, of the k-th vertex shared with shard r; -1 pads).
"""

from __future__ import annotations

import torch

from ..ops.common import scatter


def halo_exchange(vals: torch.Tensor, comm_idx: torch.Tensor) -> torch.Tensor:
    """[D, D, I, ...]: `recv[s, r, k]` is the value shard r holds at its
    side of the k-th vertex it shares with shard s (the same k order on
    both sides). Padded slots hold the row's slot-0 value and must be
    masked by the caller with `comm_idx >= 0`."""
    ci = comm_idx.long().clamp(min=0)
    d = ci.shape[0]
    src = torch.arange(d, device=vals.device)[None, :, None].expand(ci.shape)
    # recv[s, r, k] = vals[r, comm_idx[r, s, k]]
    return vals[src, ci.transpose(0, 1)]


def _combine(vals: torch.Tensor, comm_idx: torch.Tensor, op: str,
             neutral) -> torch.Tensor:
    recv = halo_exchange(vals, comm_idx)
    valid = comm_idx >= 0
    recv = torch.where(valid.reshape(valid.shape + (1,) * (vals.dim() - 2)),
                       recv, torch.as_tensor(neutral, dtype=vals.dtype,
                                             device=vals.device))
    p = vals.shape[1]
    out = []
    for s in range(vals.shape[0]):
        tgt = torch.where(valid[s], comm_idx[s], p).reshape(-1)
        out.append(scatter(vals[s], tgt,
                           recv[s].reshape((-1,) + tuple(vals.shape[2:])),
                           op))
    return torch.stack(out)


def _neutral(dtype, low: bool):
    if dtype == torch.bool:
        return not low
    if dtype.is_floating_point:
        return -torch.inf if low else torch.inf
    info = torch.iinfo(dtype)
    return info.min if low else info.max


def halo_sum(vals: torch.Tensor, comm_idx: torch.Tensor) -> torch.Tensor:
    """Each interface vertex accumulates the sum of its copies' values
    over every shard that holds it."""
    return _combine(vals, comm_idx, "add", 0)


def halo_min(vals: torch.Tensor, comm_idx: torch.Tensor) -> torch.Tensor:
    return _combine(vals, comm_idx, "min", _neutral(vals.dtype, low=False))


def halo_max(vals: torch.Tensor, comm_idx: torch.Tensor) -> torch.Tensor:
    return _combine(vals, comm_idx, "max", _neutral(vals.dtype, low=True))


def halo_or(vals: torch.Tensor, comm_idx: torch.Tensor) -> torch.Tensor:
    """Boolean or bitwise (integer) OR over the copies. Integer rows fold
    one neighbour at a time: within one neighbour's list each slot
    appears at most once, so a gather, an OR and a scatter are exact."""
    if vals.dtype == torch.bool:
        return _combine(vals, comm_idx, "max", False)
    recv = halo_exchange(vals, comm_idx)
    p = vals.shape[1]
    out = []
    for s in range(vals.shape[0]):
        o = vals[s]
        for r in range(comm_idx.shape[1]):
            idx = comm_idx[s, r].long()
            valid = idx >= 0
            cur = torch.where(valid, o[idx.clamp(min=0)], 0)
            o = scatter(o, torch.where(valid, idx, p),
                        cur | torch.where(valid, recv[s, r], 0))
        out.append(o)
    return torch.stack(out)
