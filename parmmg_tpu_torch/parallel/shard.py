"""Shard ownership across the ranks of a run, and the world reductions
over owned shards.

Counterpart of `parmmg_tpu/parallel/shard.py`. The JAX package lays the
stacked mesh's shard axis over a 1-D device mesh and lets each process
compute the shards of its devices under `shard_map`; the port has no
device mesh: each rank owns a contiguous block of shards
(`owned_shards`), computes those and joins the others' with one
`multihost.gather_stacked`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..core.mesh import Mesh
from ..ops import quality
from . import multihost


def owned_shards(nshards: int, rank: int | None = None,
                 world: int | None = None) -> tuple:
    """Shard indices rank `rank` of a world of `world` ranks owns (default:
    this process's): contiguous blocks in ascending shard order, the
    first `nshards % world` ranks one shard more, as the JAX package's
    device order gives with uniform local device counts. Ranks past
    `nshards` own none."""
    if rank is None:
        rank = multihost.rank()
    if world is None:
        world = multihost.world_size()
    per, extra = divmod(nshards, world)
    lo = rank * per + min(rank, extra)
    return tuple(range(lo, lo + per + (rank < extra)))


def _world_rows(shards: Sequence[Mesh], fn) -> List[tuple]:
    """`fn(shard)` (a tuple of tensors) of every shard on every rank:
    each rank computes its own shards' and gathers the others'; where
    some rank owns no shard, every rank computes all of them."""
    d = len(shards)
    if multihost.world_size() > d:
        return [fn(m) for m in shards]
    rows = [fn(shards[i]) for i in owned_shards(d)]
    return multihost.gather_stacked(rows, d, tag="sharded_reduction")


def _as_list(shards) -> List[Mesh]:
    if isinstance(shards, Mesh):
        from .distribute import unstack_mesh

        return unstack_mesh(shards)
    return list(shards)


def sharded_quality_histogram(shards) -> quality.QualityHisto:
    """World quality histogram of a stacked mesh (or a list of shards):
    per-shard histograms of the owned shards, joined by one collective,
    then `quality.merge_stacked_histograms` (reference `PMMG_qualhisto`,
    `src/quality_pmmg.c:156`)."""
    names = [f.name for f in dataclasses.fields(quality.QualityHisto)
             if f.name != "worst_shard"]

    def row(m):
        h = quality.quality_histogram(m)
        return tuple(getattr(h, k) for k in names)

    rows = _world_rows(_as_list(shards), row)
    return quality.merge_stacked_histograms(
        [quality.QualityHisto(**dict(zip(names, r))) for r in rows])


def sharded_length_stats(shards) -> quality.LengthStats:
    """World edge-length histogram (reference `PMMG_prilen`) of a stacked
    mesh (or a list of shards): per-shard unique-edge tables and metric
    lengths of the owned shards, joined like
    `sharded_quality_histogram`, then
    `quality.merge_stacked_length_stats`. Interface edges count once per
    shard holding them."""
    shards = _as_list(shards)
    ecap = int(shards[0].tcap * 1.7) + 64
    names = [f.name for f in dataclasses.fields(quality.LengthStats)]

    def row(m):
        ls = quality.mesh_length_stats(m, ecap)
        return tuple(getattr(ls, k) for k in names)

    rows = _world_rows(shards, row)
    return quality.merge_stacked_length_stats(
        [quality.LengthStats(**dict(zip(names, r))) for r in rows])
