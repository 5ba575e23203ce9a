"""`quality_vol`: fused per-tet quality and signed volume.

Replaces the Pallas kernel `parmmg_tpu/kernels/quality_k.py`
(`_quality_vol_pallas`, body `quality_vol_kernel`, math
`quality_vol_math`). The CUDA kernel is `csrc/quality_vol.cu`; its plain
PyTorch version is `quality_vol_plain` below, written with the same
expression order term by term (explicit cross/dot products, sequential
sums), so the two agree to the last bit where no libm function
intervenes.

    quality_vol(vert [P,3], met [P,C], tet [N,4] int32) -> (q [N], vol [N])

C is 1 (iso size h) or 6 (sym6 tensor); the dtype follows `vert`. Tet
indices follow the JAX gather convention (negative ones wrap once, the
rest is clamped), so garbage rows that the callers mask never fault.
"""

from __future__ import annotations

import torch

from . import build

_NAME = "quality_vol"


def _cross(a, b):
    """Cross product of [..., 3] rows, the `jnp.cross` component
    formulas."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _dot3(a, b):
    """Row dot product with a sequential sum."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _maxp(x, lo: float):
    """`jnp.maximum(x, lo)` (NaN propagates)."""
    return torch.clamp(x, min=lo)


def _corners(vert, tet):
    from ..ops.common import take

    return take(vert, tet)                      # [T,4,3]


def _vol_from_corners(c):
    d1, d2, d3 = c[:, 1] - c[:, 0], c[:, 2] - c[:, 0], c[:, 3] - c[:, 0]
    s = _dot3(_cross(d1, d2), d3)
    # a true division: PyTorch's CUDA `tensor / python_scalar` multiplies
    # by the reciprocal, which rounds differently from `/ 6` in the
    # kernel and in the reference
    return s / torch.full((), 6.0, dtype=s.dtype, device=s.device)


def vol_of(vert, tet):
    """Signed volumes of tet rows (plain version)."""
    return _vol_from_corners(_corners(vert, tet))


_EV = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _mean4(m4):
    return (((m4[:, 0] + m4[:, 1]) + m4[:, 2]) + m4[:, 3]) / 4.0


def quality_vol_plain(vert, met, tet):
    """(q, vol) of tet rows — the plain PyTorch version of the kernel."""
    from ..ops.common import take
    from ..ops.quality import ALPHA

    c = _corners(vert, tet)
    vol = _vol_from_corners(c)
    e = [c[:, b] - c[:, a] for a, b in _EV]
    m4 = take(met, tet)                          # [T,4,C]
    if met.shape[1] == 6:
        mt = _mean4(m4)                          # [T,6]
        m11, m12, m13, m22, m23, m33 = (mt[:, j] for j in range(6))
        M = ((m11, m12, m13), (m12, m22, m23), (m13, m23, m33))
        l2 = []
        for ek in e:
            w = [(ek[:, 0] * M[0][j] + ek[:, 1] * M[1][j])
                 + ek[:, 2] * M[2][j] for j in range(3)]
            l2.append((w[0] * ek[:, 0] + w[1] * ek[:, 1]) + w[2] * ek[:, 2])
        det = (
            m11 * (m22 * m33 - m23 * m23)
            - m12 * (m12 * m33 - m23 * m13)
            + m13 * (m12 * m23 - m22 * m13)
        )
        volm = vol * torch.sqrt(_maxp(det, 0.0))
    else:
        h = _mean4(m4[..., 0])
        h2 = _maxp(h * h, 1e-30)
        l2 = [_dot3(ek, ek) / h2 for ek in e]
        volm = vol / _maxp((h * h) * h, 1e-30)
    rap = l2[0]
    for x in l2[1:]:
        rap = rap + x
    q = (ALPHA * volm) / torch.pow(_maxp(rap, 1e-30), 1.5)
    q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
    return q, vol


def _check_tables(vert, met):
    if vert.dim() != 2 or vert.shape[1] != 3:
        raise ValueError(f"vert must be [P,3], got {tuple(vert.shape)}")
    if vert.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vert must be float32/float64, got {vert.dtype}")
    if met is not None:
        if met.dim() != 2 or met.shape[1] not in (1, 6) \
                or met.shape[0] != vert.shape[0]:
            raise ValueError(f"met must be [P,1|6], got {tuple(met.shape)}")
        if met.dtype != vert.dtype or met.device != vert.device:
            raise TypeError("met must match vert in dtype and device")
    for t in (vert, met):
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel tables must be contiguous")


def _check_stream(t, cols, dtype, n, device, what):
    if t.dim() != (2 if cols else 1) or t.shape[0] != n \
            or (cols and t.shape[1] != cols):
        raise ValueError(f"{what}: bad shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous on {device}")


def quality_vol(vert, met, tet):
    """(q [N], vol [N]): the CUDA kernel for CUDA tensors, the plain
    version for tensors on the CPU."""
    if vert.device.type == "cpu":
        return quality_vol_plain(vert, met, tet)
    from ..ops.quality import ALPHA

    _check_tables(vert, met)
    n = tet.shape[0]
    _check_stream(tet, 4, torch.int32, n, vert.device, "tet")
    q = torch.empty(n, dtype=vert.dtype, device=vert.device)
    vol = torch.empty(n, dtype=vert.dtype, device=vert.device)
    if n == 0:
        build.count_empty(_NAME)
        return q, vol
    fn = build.function(_NAME, vert.dtype)
    rc = fn(vert.data_ptr(), met.data_ptr(), met.shape[1], vert.shape[0],
            tet.data_ptr(), n, ALPHA, q.data_ptr(), vol.data_ptr(),
            build.stream_ptr(vert))
    build.check(rc, _NAME)
    build.count(_NAME, n, vert.shape[0])
    return q, vol
