"""Cavity kernels of collapse and split.

`collapse_cavity` replaces the Pallas kernel
`parmmg_tpu/kernels/cavity_k.py:_collapse_cavity_pallas` (body
`collapse_cavity_kernel`): the quality of each retargeted ball tet where
its volume clears `vol_floor`, else -inf — the operand of collapse's
ball-min scatter. CUDA source: `csrc/collapse_cavity.cu`.

`split_midpoint` replaces `_split_midpoint_pallas` (body
`split_midpoint_kernel`): both children of each incident tet, with the
offset midpoint `newp` at local slot `lj`, resp. `li`, keep a volume
above `POS_VOL_FRAC` of the parent's |volume|. CUDA source:
`csrc/split_midpoint.cu`.

    collapse_cavity(vert [P,3], met [P,C], new_tet [N,4] i32,
                    vol_floor [N]) -> gated quality [N]
    split_midpoint(vert [P,3], tet [N,4] i32, newp [N,3],
                   li [N] i32, lj [N] i32) -> ok [N] bool

The plain PyTorch versions sit beside the wrappers; the boolean and the
-inf gate of the kernels match them exactly.
"""

from __future__ import annotations

import math

import torch

from . import build
from .quality_k import (_check_stream, _check_tables, _corners,
                        _vol_from_corners, quality_vol_plain)


def collapse_cavity_plain(vert, met, new_tet, vol_floor):
    q_new, vol_new = quality_vol_plain(vert, met, new_tet)
    return torch.where(vol_new > vol_floor, q_new,
                       torch.full_like(q_new, -math.inf))


def collapse_cavity(vert, met, new_tet, vol_floor):
    """Gated cavity quality: the CUDA kernel for CUDA tensors, the plain
    version for tensors on the CPU."""
    if vert.device.type == "cpu":
        return collapse_cavity_plain(vert, met, new_tet, vol_floor)
    from ..ops.quality import ALPHA

    _check_tables(vert, met)
    n = new_tet.shape[0]
    _check_stream(new_tet, 4, torch.int32, n, vert.device, "new_tet")
    _check_stream(vol_floor, 0, vert.dtype, n, vert.device, "vol_floor")
    out = torch.empty(n, dtype=vert.dtype, device=vert.device)
    if n == 0:
        build.count_empty("collapse_cavity")
        return out
    fn = build.function("collapse_cavity", vert.dtype)
    rc = fn(vert.data_ptr(), met.data_ptr(), met.shape[1], vert.shape[0],
            new_tet.data_ptr(), vol_floor.data_ptr(), n, ALPHA,
            out.data_ptr(), build.stream_ptr(vert))
    build.check(rc, "collapse_cavity")
    build.count("collapse_cavity", n, vert.shape[0])
    return out


def split_midpoint_plain(vert, tet, newp, li, lj):
    from ..ops.common import POS_VOL_FRAC

    c = _corners(vert, tet)                          # [N,4,3]
    slot = torch.arange(4, device=tet.device)[None, :, None]
    cA = torch.where(slot == lj.long()[:, None, None], newp[:, None, :], c)
    cB = torch.where(slot == li.long()[:, None, None], newp[:, None, :], c)
    floor = POS_VOL_FRAC * torch.abs(_vol_from_corners(c))
    return (_vol_from_corners(cA) > floor) & (_vol_from_corners(cB) > floor)


def split_midpoint(vert, tet, newp, li, lj):
    """Child-volume validity of the offset midpoint: the CUDA kernel for
    CUDA tensors, the plain version for tensors on the CPU."""
    if vert.device.type == "cpu":
        return split_midpoint_plain(vert, tet, newp, li, lj)
    from ..ops.common import POS_VOL_FRAC

    _check_tables(vert, None)
    n = tet.shape[0]
    _check_stream(tet, 4, torch.int32, n, vert.device, "tet")
    _check_stream(newp, 3, vert.dtype, n, vert.device, "newp")
    _check_stream(li, 0, torch.int32, n, vert.device, "li")
    _check_stream(lj, 0, torch.int32, n, vert.device, "lj")
    ok = torch.empty(n, dtype=torch.bool, device=vert.device)
    if n == 0:
        build.count_empty("split_midpoint")
        return ok
    fn = build.function("split_midpoint", vert.dtype)
    rc = fn(vert.data_ptr(), vert.shape[0], tet.data_ptr(), newp.data_ptr(),
            li.data_ptr(), lj.data_ptr(), n, POS_VOL_FRAC, ok.data_ptr(),
            build.stream_ptr(vert))
    build.check(rc, "split_midpoint")
    build.count("split_midpoint", n, vert.shape[0])
    return ok
