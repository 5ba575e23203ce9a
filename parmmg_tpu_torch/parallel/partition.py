"""Space-filling-curve mesh partitioning.

Counterpart of `parmmg_tpu/parallel/partition.py` (`tet_morton_keys`,
`metric_weights`, `sfc_partition`): tets are ordered by the Morton key of
their barycenter and cut into contiguous ranges of equal weight — one
stable sort and one prefix sum.

The weights are float32 as in the reference, and a float32 prefix sum
depends on its order of summation. `prefix_sum` fixes that order to the
one XLA's CPU backend uses for `jnp.cumsum` (tiles of 16 summed in
sequence, the tiles' totals prefix-summed the same way and added on), so
the cut is the same on the CPU, on the GPU and in the JAX package.
"""

from __future__ import annotations

import torch

from ..core import metric as metric_mod, sfc
from ..core.mesh import Mesh, tet_volumes
from ..ops.common import take
from ..ops.locate import _box, _mean_rows

# tile length of the order-fixed prefix sum
_TILE = 16


def prefix_sum(x):
    """Inclusive prefix sum of a 1-D tensor in a fixed order of
    summation: sequential within tiles of 16, the tiles' totals
    prefix-summed recursively and added to the following tiles."""
    n = x.shape[0]
    if n <= _TILE:
        out = [x[:1]] if n else []
        for k in range(1, n):
            out.append(out[-1] + x[k:k + 1])
        return torch.cat(out) if n else x.clone()
    m = -(-n // _TILE)
    tiles = torch.cat([x, x.new_zeros(m * _TILE - n)]).reshape(m, _TILE)
    cols = [tiles[:, 0]]
    for k in range(1, _TILE):
        cols.append(cols[-1] + tiles[:, k])
    inner = torch.stack(cols, dim=1)
    outer = prefix_sum(inner[:, -1].contiguous())
    carry = torch.cat([x.new_zeros(1), outer[:-1]])
    return (inner + carry[:, None]).reshape(-1)[:n]


def tet_morton_keys(mesh: Mesh):
    """[TC] int32 Morton key of each valid tet barycenter (dead slots get
    the dead key, so they sort last)."""
    bc = _mean_rows(take(mesh.vert, mesh.tet))
    lo, hi = _box(bc, mesh.tmask)
    return torch.where(mesh.tmask, sfc.morton_keys(bc, lo, hi),
                       sfc.DEAD_KEY)


def metric_weights(mesh: Mesh):
    """[TC] float32 predicted output-element count per tet under the
    current metric (vol(t) * mean sqrt(det M) over its corners), floored
    at 1e-3 of the mean so zero-density regions keep some weight."""
    vol = tet_volumes(mesh).abs()
    dens = metric_mod.metric_det(mesh.met)
    dens_t = _mean_rows(torch.sqrt(torch.clamp(take(dens, mesh.tet),
                                               min=0.0))[..., None])[:, 0]
    w = (vol * dens_t).to(torch.float32)
    live = mesh.tmask
    mean_w = torch.where(live, w, 0.0).sum() / torch.clamp(
        live.to(torch.float32).sum(), min=1.0)
    w = torch.maximum(w, 1e-3 * torch.clamp(mean_w, min=1e-30))
    return torch.where(live, w, 0.0)


def sfc_partition(mesh: Mesh, nparts: int, weights=None):
    """[TC] int32 part id per tet (-1 for dead slots): tets sorted along
    the Morton curve, the weight prefix sum cut into `nparts` equal
    ranges."""
    keys = tet_morton_keys(mesh)
    w = (torch.ones(mesh.tcap, dtype=torch.float32, device=mesh.device)
         if weights is None else weights)
    w = torch.where(mesh.tmask, w, 0.0)
    order = torch.argsort(keys, stable=True)
    wsort = w[order]
    csum = prefix_sum(wsort)
    total = csum[-1]
    # part of sorted position i: how many cut points its mid-weight passes
    mid = csum - 0.5 * wsort
    part_sorted = torch.clamp(
        (mid * nparts / torch.clamp(total, min=1e-30)).to(torch.int32),
        0, nparts - 1)
    part = torch.zeros(mesh.tcap, dtype=torch.int32, device=mesh.device)
    part[order] = part_sorted
    return torch.where(mesh.tmask, part, -1)
