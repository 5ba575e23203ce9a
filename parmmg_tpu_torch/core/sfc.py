"""Space-filling-curve (Morton) keys for spatial seeding and partitioning.

Counterpart of `parmmg_tpu/core/sfc.py`: 30-bit Morton keys of points
quantized to a 2^10 grid per axis. PyTorch has no uint32, so the bit
arithmetic runs in int64 and every intermediate is masked as in the
reference; the keys fit int32 and are returned as int32.
"""

from __future__ import annotations

import torch

MORTON_BITS = 10  # 10 bits/axis -> 30-bit keys, fits int32

# key of dead slots: sorts after every real key
DEAD_KEY = 2**30


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(ix, iy, iz) -> torch.Tensor:
    """Interleave three 10-bit integer coords into a 30-bit Morton key."""
    return (_spread3(ix) | (_spread3(iy) << 1)
            | (_spread3(iz) << 2)).to(torch.int32)


def quantize(pts, lo, hi) -> torch.Tensor:
    """[...,3] float coords -> [...,3] integer grid coords in [0, 2^10).

    The float-to-int conversion truncates towards zero like XLA's; the
    value is bounded first (NaN to 0) so that far-out points clip as
    they do there instead of overflowing int32."""
    top = 2**MORTON_BITS - 1
    ext = torch.clamp(hi - lo, min=1e-30)
    # a true division (`python_scalar / tensor` multiplies by the
    # reciprocal, which rounds differently)
    scale = torch.full_like(ext, float(top)) / ext
    q = (pts - lo) * scale
    q = torch.nan_to_num(q, nan=0.0).clamp(-1.0, float(top + 1))
    return torch.clamp(q.to(torch.int32), 0, top)


def morton_keys(pts, lo, hi) -> torch.Tensor:
    """[...] int32 Morton key of each point within the box [lo, hi]."""
    q = quantize(pts, lo, hi)
    return morton3d(q[..., 0], q[..., 1], q[..., 2])
