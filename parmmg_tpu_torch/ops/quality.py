"""Tetrahedron quality measures, histograms and edge-length statistics.

Counterpart of `parmmg_tpu/ops/quality.py`. Quality: q(K) = ALPHA *
V_M(K) / (sum of squared metric edge lengths)^(3/2), normalized so the
regular tetrahedron scores 1; every evaluation goes through the
`quality_vol` kernel (CUDA on the GPU, its plain version on the CPU).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import metric as metric_mod
from ..core.mesh import Mesh

# normalization: regular tet edge a has V = a^3 sqrt(2)/12, sum l^2 = 6 a^2
ALPHA = 6.0**1.5 * 12.0 / math.sqrt(2.0)

# an element under this quality counts as "bad" in reports
BADQUAL = 0.012


def tet_quality(mesh: Mesh) -> torch.Tensor:
    """[TC] quality for valid tets (0 where masked/degenerate)."""
    from .. import kernels

    q, _ = kernels.quality_vol(mesh.vert, mesh.met,
                               mesh.tet.to(torch.int32).contiguous())
    return torch.where(mesh.tmask, q, torch.zeros_like(q))


@dataclasses.dataclass(frozen=True)
class QualityHisto:
    """Result of a quality histogram (0-d tensors + bin counts)."""

    ne: torch.Tensor
    qmin: torch.Tensor
    qmax: torch.Tensor
    qavg: torch.Tensor
    worst_elt: torch.Tensor
    nbad: torch.Tensor
    ninverted: torch.Tensor
    counts: torch.Tensor
    # shard of the worst element in a merged stacked histogram, else -1
    worst_shard: object = -1


def quality_histogram(mesh: Mesh, nbins: int = 5) -> QualityHisto:
    """5 uniform bins of width 0.2 plus BEST/AVRG/WRST and the worst
    element's slot (the reference's `PMMG_qualhisto`)."""
    q = tet_quality(mesh)
    m = mesh.tmask
    ne = m.to(torch.int32).sum()
    qv = torch.where(m, q, math.inf)
    qmin = qv.min()
    worst = torch.argmin(qv)
    qmax = torch.where(m, q, -math.inf).max()
    qavg = torch.where(m, q, 0.0).sum() / torch.clamp(ne, min=1)
    nbad = (m & (q < BADQUAL)).to(torch.int32).sum()
    ninv = (m & (q <= 0.0)).to(torch.int32).sum()
    bins = torch.clamp((q * nbins).to(torch.int32), 0, nbins - 1)
    counts = torch.zeros(nbins, dtype=torch.int32, device=q.device)
    counts.index_add_(0, bins.long(), m.to(torch.int32))
    return QualityHisto(ne, qmin, qmax, qavg, worst, nbad, ninv, counts)


def merge_stacked_histograms(hs) -> QualityHisto:
    """One world histogram from the per-shard histograms `hs` (a list):
    sums, extrema, the element-weighted mean, and the worst element of
    the lowest shard holding the minimum."""
    st = {f.name: torch.stack([getattr(h, f.name) for h in hs])
          for f in dataclasses.fields(QualityHisto)
          if f.name != "worst_shard"}
    ne = st["ne"].sum()
    worst_shard = torch.argmin(st["qmin"])
    return QualityHisto(
        ne=ne, qmin=st["qmin"].min(), qmax=st["qmax"].max(),
        qavg=(st["qavg"] * st["ne"].to(st["qavg"].dtype)).sum()
        / torch.clamp(ne, min=1).to(st["qavg"].dtype),
        worst_elt=st["worst_elt"][worst_shard], nbad=st["nbad"].sum(),
        ninverted=st["ninverted"].sum(), counts=st["counts"].sum(dim=0),
        worst_shard=worst_shard,
    )


def _finite_or_dash(v, fmt: str = "8.6f") -> str:
    v = float(v)
    return format(v, fmt) if math.isfinite(v) else "   --   "


def format_histogram(h: QualityHisto, label: str = "MESH QUALITY") -> str:
    """Human-readable report in the style of the reference's histogram."""
    counts = [int(c) for c in h.counts.cpu()]
    n = len(counts)
    lines = [
        f"  -- {label}  {int(h.ne)} elements",
        f"     BEST {_finite_or_dash(h.qmax)}  AVRG {_finite_or_dash(h.qavg)} "
        f" WRST {_finite_or_dash(h.qmin)} (elt {int(h.worst_elt)}"
        + (f" on shard {int(h.worst_shard)})" if int(h.worst_shard) >= 0
           else ")"),
    ]
    ne = max(int(h.ne), 1)
    for k in reversed(range(n)):
        lo, hi = k / n, (k + 1) / n
        lines.append(
            f"     {lo:4.2f} < Q < {hi:4.2f}  {counts[k]:10d}  "
            f"{100.0 * counts[k] / ne:6.2f} %"
        )
    if int(h.nbad):
        lines.append(f"     {int(h.nbad)} elements under quality {BADQUAL}")
    if int(h.ninverted):
        lines.append(f"     {int(h.ninverted)} INVERTED elements")
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class LengthStats:
    """Edge-length histogram (the reference's `PMMG_prilen`)."""

    nedge: torch.Tensor
    lmin: torch.Tensor
    lmax: torch.Tensor
    lavg: torch.Tensor
    n_small: torch.Tensor
    n_large: torch.Tensor
    n_unit: torch.Tensor
    counts: torch.Tensor


# the reference's length-histogram bounds (`bd[9]`)
_LEN_EDGES = np.array(
    [0.0, 0.3, 0.6, float(metric_mod.LSHRT), 0.9, 1.3,
     float(metric_mod.LLONG), 2.0, 5.0]
)


def length_stats(mesh: Mesh, edges, emask) -> LengthStats:
    from .common import take

    a, b = edges[:, 0], edges[:, 1]
    l = metric_mod.edge_length(take(mesh.vert, a), take(mesh.vert, b),
                               take(mesh.met, a), take(mesh.met, b))
    l = torch.where(emask, l, math.nan)
    ne = emask.to(torch.int32).sum()
    lmin = torch.where(emask, l, math.inf).min()
    lmax = torch.where(emask, l, -math.inf).max()
    lavg = torch.where(emask, l, 0.0).sum() / torch.clamp(ne, min=1)
    small = (emask & (l < metric_mod.LSHRT)).to(torch.int32).sum()
    large = (emask & (l > metric_mod.LLONG)).to(torch.int32).sum()
    unit = ne - small - large
    bounds = torch.as_tensor(_LEN_EDGES, dtype=l.dtype, device=l.device)
    k = torch.searchsorted(bounds, torch.where(emask, l, 0.0).contiguous())
    counts = torch.zeros(_LEN_EDGES.shape[0] + 1, dtype=torch.int32,
                         device=l.device)
    counts.index_add_(0, k, emask.to(torch.int32))
    return LengthStats(ne, lmin, lmax, lavg, small, large, unit, counts)


def mesh_length_stats(mesh: Mesh, ecap: int | None = None) -> LengthStats:
    """Whole-mesh edge-length histogram from the tet connectivity."""
    from ..core import adjacency

    if ecap is None:
        ecap = int(mesh.tcap * 1.7) + 64
    edges, emask, _, _ = adjacency.unique_edges(mesh, ecap)
    return length_stats(mesh, edges, emask)


def merge_stacked_length_stats(ls_list) -> LengthStats:
    """One world edge-length record from the per-shard records (a
    list), as `merge_stacked_histograms` merges histograms."""
    st = {f.name: torch.stack([getattr(x, f.name) for x in ls_list])
          for f in dataclasses.fields(LengthStats)}
    ne = st["nedge"].sum()
    return LengthStats(
        nedge=ne, lmin=st["lmin"].min(), lmax=st["lmax"].max(),
        lavg=(st["lavg"] * st["nedge"].to(st["lavg"].dtype)).sum()
        / torch.clamp(ne, min=1).to(st["lavg"].dtype),
        n_small=st["n_small"].sum(), n_large=st["n_large"].sum(),
        n_unit=st["n_unit"].sum(), counts=st["counts"].sum(dim=0),
    )


def in_band_fraction(ls: LengthStats) -> float:
    """Fraction of edges with metric length in [LSHRT, LLONG]."""
    ne = int(ls.nedge)
    return float(int(ls.n_unit)) / ne if ne > 0 else 0.0


def length_stats_doc(ls: LengthStats) -> dict:
    """JSON-ready dict of a LengthStats (non-finite scalars -> None)."""
    def fin(v):
        return float(v) if math.isfinite(float(v)) else None

    return dict(
        nedge=int(ls.nedge),
        lmin=fin(ls.lmin), lmax=fin(ls.lmax), lavg=fin(ls.lavg),
        n_small=int(ls.n_small), n_large=int(ls.n_large),
        n_unit=int(ls.n_unit),
        in_band=round(in_band_fraction(ls), 6),
        counts=[int(c) for c in ls.counts.cpu()],
        edges=[float(e) for e in _LEN_EDGES],
    )


def format_length_stats(ls: LengthStats) -> str:
    """Edge-length report with the reference's bins."""
    edges = [float(e) for e in _LEN_EDGES]
    counts = [int(c) for c in ls.counts.cpu()]
    ne = max(int(ls.nedge), 1)
    lines = [
        f"  -- RESULTING EDGE LENGTHS  {int(ls.nedge)} edges",
        f"     AVERAGE LENGTH {_finite_or_dash(ls.lavg, '12.4f')}",
        f"     SMALLEST EDGE  {_finite_or_dash(ls.lmin, '12.4f')}",
        f"     LARGEST  EDGE  {_finite_or_dash(ls.lmax, '12.4f')}",
        f"     unit [1/sqrt2, sqrt2]: {int(ls.n_unit)} "
        f"({100.0 * int(ls.n_unit) / ne:.2f} %)",
    ]
    for k in range(len(edges) - 1):
        c = counts[k + 1]
        lines.append(
            f"     {edges[k]:6.2f} < L < {edges[k + 1]:6.2f}  "
            f"{c:10d}  {100.0 * c / ne:6.2f} %"
        )
    c_over = counts[len(edges)]
    lines.append(
        f"     {edges[-1]:6.2f} < L          {c_over:10d}  "
        f"{100.0 * c_over / ne:6.2f} %"
    )
    return "\n".join(lines)
