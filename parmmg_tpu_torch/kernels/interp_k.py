"""`interp_bary`: clamped barycentric weights of located points and the
metric interpolated there, in one pass.

Replaces the Pallas kernel `parmmg_tpu/kernels/interp_k.py`
(`_interp_bary_pallas`, body `interp_bary_kernel`, reference
`_interp_bary_ref`). The CUDA kernel is `csrc/interp_bary.cu`; its plain
PyTorch version is `interp_bary_plain` below, in the kernel's expression
order (the barycentric volumes of `ops.locate.tet_barycoords`, then
`clamp_bary`, then `core.metric.interp_metric` with its sums left to
right).

    interp_bary(vert [P,3], met [P,C], vids [Q,4] i32, pts [Q,3])
        -> (bary [Q,4], met_q [Q,C])

or, stacked over D shards (each row indexes its own shard's table),

    interp_bary(vert [D,P,3], met [D,P,C], vids [D,Q,4] i32,
                pts [D,Q,3]) -> (bary [D,Q,4], met_q [D,Q,C])

Routing, by the metric's width and the tensors' device only:
- C = 6 (anisotropic): the log-Euclidean mean needs an eigendecomposition
  per point, so the wrapper takes the plain version on every device, as
  the Pallas wrapper sends such calls to its reference; the launch
  counter does not move;
- C = 1 on CPU tensors: the plain version;
- C = 1 on CUDA tensors: one launch of the CUDA kernel over all D*Q rows,
  or an error.
"""

from __future__ import annotations

import torch

from . import build
from .quality_k import _check_stream, _check_tables

_NAME = "interp_bary"


def interp_bary_plain(vert, met, vids, pts):
    """(bary, met_q) — the plain PyTorch version (2-D or stacked)."""
    from ..core import metric as metric_mod
    from ..ops import locate

    if vert.dim() == 3:
        outs = [interp_bary_plain(vert[s], met[s], vids[s], pts[s])
                for s in range(vert.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    from ..ops.common import take

    bary = locate.clamp_bary(locate.tet_barycoords(take(vert, vids), pts))
    return bary, metric_mod.interp_metric(take(met, vids), bary)


def _check(vert, met, vids, pts) -> None:
    if vert.dim() not in (2, 3):
        raise ValueError(f"vert must be [P,3] or [D,P,3], got "
                         f"{tuple(vert.shape)}")
    if met.shape[:-1] != vert.shape[:-1] \
            or vids.shape[:-2] != vert.shape[:-2] \
            or pts.shape[:-1] != vids.shape[:-1]:
        raise ValueError(
            f"interp_bary: shapes vert {tuple(vert.shape)}, met "
            f"{tuple(met.shape)}, vids {tuple(vids.shape)}, pts "
            f"{tuple(pts.shape)} do not fit one table and one stream (per "
            "shard)")
    if not all(t.is_contiguous() for t in (vert, met, vids, pts)):
        raise ValueError("interp_bary: tensors must be contiguous")
    if vert.shape[-2] == 0 and vids.numel():
        raise ValueError("interp_bary needs a non-empty table")
    _check_tables(vert.reshape(-1, 3), met.reshape(-1, met.shape[-1]))
    rows = vids.numel() // max(vids.shape[-1], 1)
    _check_stream(vids.reshape(rows, -1), 4, torch.int32, rows,
                  vert.device, "vids")
    _check_stream(pts.reshape(rows, -1), 3, vert.dtype, rows, vert.device,
                  "pts")


def interp_bary(vert, met, vids, pts):
    """(bary, met_q): the CUDA kernel for iso metrics on CUDA tensors,
    the plain version for anisotropic metrics and for CPU tensors."""
    if met.shape[-1] != 1 or vert.device.type == "cpu":
        return interp_bary_plain(vert, met, vids, pts)
    _check(vert, met, vids, pts)
    d = vert.shape[0] if vert.dim() == 3 else 1
    p, q = vert.shape[-2], vids.shape[-2]
    lead = tuple(vids.shape[:-1])
    bary = torch.empty(lead + (4,), dtype=vert.dtype, device=vert.device)
    met_q = torch.empty(lead + (1,), dtype=vert.dtype, device=vert.device)
    if d * q == 0:
        return bary, met_q
    fn = build.function(_NAME, vert.dtype)
    rc = fn(vert.data_ptr(), met.data_ptr(), p, vids.data_ptr(),
            pts.data_ptr(), d, q, bary.data_ptr(), met_q.data_ptr(),
            build.stream_ptr(vert))
    build.check(rc, _NAME)
    build.count(_NAME, q, p, d if vert.dim() == 3 else None)
    return bary, met_q
