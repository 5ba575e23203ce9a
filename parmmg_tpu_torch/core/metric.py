"""Metric-tensor algebra: iso/aniso sizes, metric lengths, gradation.

Counterpart of `parmmg_tpu/core/metric.py`. An isotropic metric is the
size h itself ([...,1]); an anisotropic one is the 6-vector (m11, m12,
m13, m22, m23, m33) of an SPD tensor M, and an edge's metric length is
sqrt(e^T M e). `log_sym6`/`exp_sym6` use `torch.linalg.eigh`, as the
reference uses `jnp.linalg.eigh`; the gradation loops are Python loops.
"""

from __future__ import annotations

import math

import torch

LLONG = math.sqrt(2.0)
LSHRT = 1.0 / math.sqrt(2.0)


def sym6_to_mat(m6):
    """[...,6] -> [...,3,3] symmetric."""
    m11, m12, m13, m22, m23, m33 = torch.unbind(m6, -1)
    row0 = torch.stack([m11, m12, m13], -1)
    row1 = torch.stack([m12, m22, m23], -1)
    row2 = torch.stack([m13, m23, m33], -1)
    return torch.stack([row0, row1, row2], -2)


def mat_to_sym6(m):
    return torch.stack(
        [m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 1, 1],
         m[..., 1, 2], m[..., 2, 2]], -1,
    )


def iso_to_sym6(h):
    """[...,1] iso size -> [...,6] tensor (1/h^2) I."""
    lam = 1.0 / (h[..., 0] * h[..., 0])
    z = torch.zeros_like(lam)
    return torch.stack([lam, z, z, lam, z, lam], -1)


def _norm3(d):
    return torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                      + d[..., 2] * d[..., 2])


def _quad(e, M):
    """e^T M e for [...,3] vectors and [...,3,3] tensors, sequential sums."""
    w = [(e[..., 0] * M[..., 0, j] + e[..., 1] * M[..., 1, j])
         + e[..., 2] * M[..., 2, j] for j in range(3)]
    return (w[0] * e[..., 0] + w[1] * e[..., 1]) + w[2] * e[..., 2]


def edge_length_iso(p0, p1, h0, h1, eps=1e-30):
    """|e| * (1/h0 + 1/h1) / 2."""
    d = _norm3(p1 - p0)
    return d * 0.5 * (1.0 / torch.clamp(h0[..., 0], min=eps)
                      + 1.0 / torch.clamp(h1[..., 0], min=eps))


def edge_length_aniso(p0, p1, m0, m1):
    """( sqrt(e^T M0 e) + sqrt(e^T M1 e) ) / 2."""
    e = p1 - p0
    q0 = _quad(e, sym6_to_mat(m0))
    q1 = _quad(e, sym6_to_mat(m1))
    return 0.5 * (torch.sqrt(torch.clamp(q0, min=0.0))
                  + torch.sqrt(torch.clamp(q1, min=0.0)))


def edge_length(p0, p1, met0, met1):
    if met0.shape[-1] == 1:
        return edge_length_iso(p0, p1, met0, met1)
    return edge_length_aniso(p0, p1, met0, met1)


def _sym_eigh(m6):
    return torch.linalg.eigh(sym6_to_mat(m6))


def _recompose(v, w):
    return mat_to_sym6(torch.einsum("...ik,...k,...jk->...ij", v, w, v))


def log_sym6(m6, eps=1e-30):
    w, v = _sym_eigh(m6)
    return _recompose(v, torch.log(torch.clamp(w, min=eps)))


def exp_sym6(m6):
    w, v = _sym_eigh(m6)
    return _recompose(v, torch.exp(w))


def interp_metric(mets, bary):
    """Barycentric metric interpolation: harmonic in h (iso), the
    log-Euclidean mean (aniso)."""
    if mets.shape[-1] == 1:
        # the sum over the corners left to right, as XLA reduces it, so
        # the result does not depend on the device's reduction order
        w = bary[..., None] / torch.clamp(mets, min=1e-30)
        inv = w[..., 0, :]
        for k in range(1, w.shape[-2]):
            inv = inv + w[..., k, :]
        return torch.ones_like(inv) / torch.clamp(inv, min=1e-30)
    logs = log_sym6(mets)
    mean = torch.sum(bary[..., None] * logs, dim=-2)
    return exp_sym6(mean)


def metric_det(met):
    """det(M): [...,1] iso -> h^-6 ; [...,6] aniso -> det of the tensor."""
    if met.shape[-1] == 1:
        h = met[..., 0]
        h2 = h * h
        return 1.0 / torch.clamp((h2 * h2) * h2, min=1e-30)
    m11, m12, m13, m22, m23, m33 = torch.unbind(met, -1)
    return (
        m11 * (m22 * m33 - m23 * m23)
        - m12 * (m12 * m33 - m23 * m13)
        + m13 * (m12 * m23 - m22 * m13)
    )


def constant_iso_metric(npoints_cap: int, hsiz: float, dtype=torch.float32,
                        device=None):
    """`-hsiz` constant-size metric."""
    return torch.full((npoints_cap, 1), hsiz, dtype=dtype, device=device)


def implied_iso_metric(vert, tet, tmask, pcap, clip=(1e-30, 1e30)):
    """Per-vertex size implied by the mesh: mean length of incident edges."""
    from ..ops.common import scatter, take
    from .mesh import EDGE_VERTS

    ev = tet[:, torch.as_tensor(EDGE_VERTS, dtype=torch.int64,
                                device=tet.device)]          # [T,6,2]
    d = _norm3(take(vert, ev[..., 1]) - take(vert, ev[..., 0]))
    d = torch.where(tmask[:, None], d, 0.0)
    w = torch.where(tmask[:, None], torch.ones_like(d), 0.0)
    acc = torch.zeros(pcap, dtype=vert.dtype, device=vert.device)
    cnt = torch.zeros(pcap, dtype=vert.dtype, device=vert.device)
    for k in (0, 1):
        acc = scatter(acc, ev[..., k].reshape(-1), d.reshape(-1), "add")
        cnt = scatter(cnt, ev[..., k].reshape(-1), w.reshape(-1), "add")
    h = acc / torch.clamp(cnt, min=1.0)
    h = torch.where(cnt > 0, h, 1.0)
    return torch.clamp(h, *clip)[:, None]


def implied_aniso_metric(vert, tet, tmask, pcap, ratio_max: float = 4.0):
    """Per-vertex tensor implied by the mesh (`-A` without a metric
    file): least-squares unit-length fit, projected to SPD within
    `ratio_max` of the iso implied size."""
    from ..ops.common import scatter, take
    from .mesh import EDGE_VERTS

    ev = tet[:, torch.as_tensor(EDGE_VERTS, dtype=torch.int64,
                                device=tet.device)].reshape(-1, 2)
    live = tmask.repeat_interleave(6)
    e = take(vert, ev[:, 1]) - take(vert, ev[:, 0])
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    r = torch.stack(
        [ex * ex, 2 * ex * ey, 2 * ex * ez, ey * ey, 2 * ey * ez, ez * ez],
        dim=-1,
    )
    rr = r[:, :, None] * r[:, None, :]
    w = live.to(vert.dtype)
    N = torch.zeros((pcap, 6, 6), dtype=vert.dtype, device=vert.device)
    rhs = torch.zeros((pcap, 6), dtype=vert.dtype, device=vert.device)
    for k in (0, 1):
        idx = torch.where(live, ev[:, k], pcap)
        N = scatter(N, idx, rr * w[:, None, None], "add")
        rhs = scatter(rhs, idx, r * w[:, None], "add")
    tr = torch.diagonal(N, dim1=-2, dim2=-1).sum(-1)
    N = N + (1e-6 * torch.clamp(tr, min=1e-30) / 6.0)[:, None, None] \
        * torch.eye(6, dtype=vert.dtype, device=vert.device)
    m6 = torch.linalg.solve(N, rhs[..., None])[..., 0]
    h_iso = implied_iso_metric(vert, tet, tmask, pcap)[:, 0]
    lam_mid = 1.0 / torch.clamp(h_iso, min=1e-30) ** 2
    lo = lam_mid / ratio_max**2
    hi = lam_mid * ratio_max**2
    wv, v = _sym_eigh(m6)
    wv = torch.minimum(torch.maximum(wv, lo[:, None]), hi[:, None])
    out = _recompose(v, wv)
    return torch.where(torch.isfinite(out).all(-1, keepdim=True), out,
                       iso_to_sym6(h_iso[:, None]))


def apply_hbounds(met, hmin, hmax):
    """Clamp metric sizes into [hmin, hmax] (iso: clamp h; aniso: clamp
    eigenvalues into [hmax^-2, hmin^-2])."""
    if hmin is None and hmax is None:
        return met
    hmin = 0.0 if hmin is None else float(hmin)
    hmax = math.inf if hmax is None else float(hmax)
    if met.shape[-1] == 1:
        return torch.clamp(met, hmin, hmax)
    w, v = _sym_eigh(met)
    lo = 0.0 if math.isinf(hmax) else 1.0 / hmax**2
    hi = math.inf if hmin <= 0.0 else 1.0 / max(hmin, 1e-30) ** 2
    return _recompose(v, torch.clamp(w, lo, hi))


def gradate_iso(vert, met, edges, emask, niter: int = 20, hgrad: float = 1.3,
                fixed=None):
    """Iso gradation: h_b <- min(h_b, h_a * hgrad^(|ab|/h_a)), Jacobi
    iterated `niter` times (Mmg's `-hgrad`)."""
    from ..ops.common import scatter, take

    loghg = math.log(hgrad)
    a, b = edges[:, 0], edges[:, 1]
    d = _norm3(take(vert, b) - take(vert, a))
    h = met
    for _ in range(niter):
        ha, hb = take(h, a)[:, 0], take(h, b)[:, 0]
        cap_b = ha * torch.exp(loghg * d / torch.clamp(ha, min=1e-30))
        cap_a = hb * torch.exp(loghg * d / torch.clamp(hb, min=1e-30))
        nb = torch.where(emask, torch.minimum(hb, cap_b), hb)
        na = torch.where(emask, torch.minimum(ha, cap_a), ha)
        col = scatter(h[:, 0], b, nb, "min")
        col = scatter(col, a, na, "min")
        h = col[:, None]
        if fixed is not None:
            h = torch.where(fixed[:, None], met, h)
    return h


def gradate_from_required(vert, met, edges, emask, req, niter: int = 20,
                          hgrad: float = 1.3):
    """`-hgradreq`: sizes propagate FROM required vertices only."""
    from ..ops.common import scatter, take

    a, b = edges[:, 0], edges[:, 1]
    d = _norm3(take(vert, b) - take(vert, a))
    loghg = math.log(hgrad)
    inf = torch.tensor(math.inf, dtype=vert.dtype, device=vert.device)
    if met.shape[-1] == 1:
        h = met[:, 0]
    else:
        w, _ = _sym_eigh(met)
        h = 1.0 / torch.sqrt(torch.clamp(w[..., -1], min=1e-30))
    g = torch.where(req, h, inf)
    for _ in range(niter):
        ga, gb = take(g, a), take(g, b)
        cap_b = torch.where(torch.isfinite(ga), ga * torch.exp(
            loghg * d / torch.clamp(ga, min=1e-30)), inf)
        cap_a = torch.where(torch.isfinite(gb), gb * torch.exp(
            loghg * d / torch.clamp(gb, min=1e-30)), inf)
        g = scatter(g, b, torch.where(emask, cap_b, inf), "min")
        g = scatter(g, a, torch.where(emask, cap_a, inf), "min")
    reached = torch.isfinite(g) & ~req
    if met.shape[-1] == 1:
        capped = torch.minimum(met[:, 0], g)
        return torch.where(reached, capped, met[:, 0])[:, None]
    f = torch.where(reached & (g < h),
                    (h / torch.clamp(g, min=1e-30)) ** 2, 1.0)
    return met * f[:, None]


def _max_geneig(M, G):
    """Largest generalized eigenvalue of G v = lambda M v (batched SPD M)."""
    L = torch.linalg.cholesky(M)
    Z = torch.linalg.solve_triangular(L, G, upper=False)
    Y = torch.linalg.solve_triangular(L, Z.transpose(-1, -2), upper=False)
    w = torch.linalg.eigvalsh(0.5 * (Y + Y.transpose(-1, -2)))
    return w[..., -1]


def gradate_aniso(vert, met, edges, emask, niter: int = 8,
                  hgrad: float = 1.3, fixed=None):
    """Anisotropic gradation by log-space capping along edges
    (`MMG3D_gradsiz_ani` role), Jacobi iterated."""
    from ..ops.common import scatter, take

    loghg = math.log(hgrad)
    a, b = edges[:, 0], edges[:, 1]
    pcap = met.shape[0]
    e = take(vert, b) - take(vert, a)
    m6 = met
    for _ in range(niter):
        Ma = sym6_to_mat(take(m6, a))
        Mb = sym6_to_mat(take(m6, b))
        la = torch.sqrt(torch.clamp(_quad(e, Ma), min=0.0))
        lb = torch.sqrt(torch.clamp(_quad(e, Mb), min=0.0))
        Ga = Ma * torch.exp(-2.0 * la * loghg)[..., None, None]
        Gb = Mb * torch.exp(-2.0 * lb * loghg)[..., None, None]
        fb = _max_geneig(Mb, Ga)
        fa = _max_geneig(Ma, Gb)
        logfb = torch.log(torch.clamp(fb, min=1.0))
        logfa = torch.log(torch.clamp(fa, min=1.0))
        logf = torch.zeros(pcap, dtype=m6.dtype, device=m6.device)
        logf = scatter(logf, torch.where(emask, b, pcap),
                       torch.where(torch.isfinite(logfb), logfb, 0.0), "max")
        logf = scatter(logf, torch.where(emask, a, pcap),
                       torch.where(torch.isfinite(logfa), logfa, 0.0), "max")
        out = m6 * torch.exp(logf)[:, None]
        if fixed is not None:
            out = torch.where(fixed[:, None], met, out)
        m6 = out
    return m6
