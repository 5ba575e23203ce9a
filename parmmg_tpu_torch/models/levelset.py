"""Level-set isovalue discretization (`-ls` mode).

Counterpart of `parmmg_tpu/models/levelset.py`, host numpy as there: a
one-time preprocessing before adaptation, giving the JAX package's
arrays bit for bit. Every tetrahedron crossed by the isosurface
{ls = isovalue} is conformally split along it (marching-tetrahedra
patterns with snapped vertices), subdomain references are assigned by
side, and the isosurface is materialized as boundary triangles so the
subsequent adaptation preserves it (the role Mmg's mmg3d2 splitting
plays for `mmg3d -ls`; the reference ParMmg gates this mode off).

Conventions (Mmg's MG_MINUS/MG_PLUS/MG_ISO discipline):
 - tets with ls < isovalue get ref `ref_in` (default 3), ls > isovalue
   get `ref_out` (default 2);
 - isosurface triangles get ref `ref_iso` (default 10);
 - cut boundary triangles are split 2D-conformally and keep their ref.

Conformity across neighboring tets relies only on per-face information:
quads are triangulated along the diagonal through the smallest vertex id
and each convex sub-region is fan-triangulated from its smallest vertex,
so the two tets sharing a face always agree on its sub-triangulation.
"""

from __future__ import annotations

import numpy as np

from ..core import tags
from ..core.mesh import EDGE_VERTS, FACE_VERTS, Mesh

REF_IN = 3
REF_OUT = 2
REF_ISO = 10


def _tri_quad(q):
    """Triangulate cyclic quad [a,b,c,d] along the diagonal through its
    smallest vertex id (consistent for any viewer of the same quad)."""
    a, b, c, d = q
    if min(a, c) < min(b, d):
        return [(a, b, c), (a, c, d)]
    return [(b, c, d), (b, d, a)]


def _fan(faces):
    """Fan-triangulate a convex polyhedron given by triangulated faces:
    tets (m, tri) for every face triangle not containing the global-min
    vertex m."""
    verts = {v for f in faces for v in f}
    m = min(verts)
    out = []
    for f in faces:
        for tri in ([f] if len(f) == 3 else _tri_quad(f)):
            if m not in tri:
                out.append((m,) + tuple(tri))
    return out


def discretize_levelset(
    mesh: Mesh,
    isovalue: float = 0.0,
    ref_in: int = REF_IN,
    ref_out: int = REF_OUT,
    ref_iso: int = REF_ISO,
    snap_rel: float = 1e-6,
) -> Mesh:
    """Split `mesh` along {ls = isovalue}; returns a new conformal Mesh
    on the same device, in the same float dtype."""
    d = mesh.to_numpy()
    verts = d["verts"]
    tets = d["tets"]
    if d["ls"].shape[1] != 1:
        raise ValueError("level-set mode requires a scalar ls field")
    v = d["ls"][:, 0] - isovalue

    # snap: vertices within snap_rel of the level move onto it exactly
    # (collapses the degenerate cut patterns, Mmg's MMG3D_snpval_ls role)
    scale = max(float(np.abs(v).max()), 1e-300)
    v = np.where(np.abs(v) < snap_rel * scale, 0.0, v)
    sgn = np.sign(v).astype(np.int8)

    st = sgn[tets]                                   # [T,4]
    cut = (st.min(axis=1) < 0) & (st.max(axis=1) > 0)

    # cut points: one new vertex per sign-changing unique edge
    ev = tets[:, EDGE_VERTS].reshape(-1, 2)
    e_lo = np.minimum(ev[:, 0], ev[:, 1])
    e_hi = np.maximum(ev[:, 0], ev[:, 1])
    s_lo, s_hi = sgn[e_lo], sgn[e_hi]
    crossing = (s_lo.astype(int) * s_hi.astype(int)) < 0
    ce = np.unique(np.stack([e_lo[crossing], e_hi[crossing]], 1), axis=0)
    npo = len(verts)
    t = v[ce[:, 0]] / (v[ce[:, 0]] - v[ce[:, 1]])
    new_pts = verts[ce[:, 0]] + t[:, None] * (verts[ce[:, 1]] - verts[ce[:, 0]])

    def lerp(arr):
        return arr[ce[:, 0]] + t[:, None] * (arr[ce[:, 1]] - arr[ce[:, 0]])

    cut_id = {}
    for k, (a, b) in enumerate(ce):
        cut_id[(int(a), int(b))] = npo + k

    def cid(a, b):
        return cut_id[(min(a, b), max(a, b))]

    # --- split tets --------------------------------------------------------
    out_tets, out_refs = [], []
    iso_tris = []

    for ti in np.nonzero(~cut)[0]:
        out_tets.append(tuple(tets[ti]))
        s = st[ti]
        out_refs.append(ref_in if (s.min() < 0 or s.max() == 0) else ref_out)

    for ti in np.nonzero(cut)[0]:
        vv = [int(x) for x in tets[ti]]
        s = {x: int(sgn[x]) for x in vv}
        P = [x for x in vv if s[x] > 0]
        N = [x for x in vv if s[x] < 0]
        Z = [x for x in vv if s[x] == 0]

        regions = []  # (faces, ref)
        if len(P) == 1 and len(N) == 3:
            a, (n1, n2, n3) = P[0], N
            c1, c2, c3 = cid(a, n1), cid(a, n2), cid(a, n3)
            regions.append(([(a, c1, c2), (a, c2, c3), (a, c1, c3),
                             (c1, c2, c3)], ref_out))
            regions.append(([(n1, n2, n3), (c1, c2, c3),
                             (n1, n2, c2, c1), (n2, n3, c3, c2),
                             (n1, n3, c3, c1)], ref_in))
            iso_tris.append((c1, c2, c3))
        elif len(N) == 1 and len(P) == 3:
            a, (n1, n2, n3) = N[0], P
            c1, c2, c3 = cid(a, n1), cid(a, n2), cid(a, n3)
            regions.append(([(a, c1, c2), (a, c2, c3), (a, c1, c3),
                             (c1, c2, c3)], ref_in))
            regions.append(([(n1, n2, n3), (c1, c2, c3),
                             (n1, n2, c2, c1), (n2, n3, c3, c2),
                             (n1, n3, c3, c1)], ref_out))
            iso_tris.append((c1, c2, c3))
        elif len(P) == 2 and len(N) == 2:
            p1, p2 = P
            n1, n2 = N
            c11, c12 = cid(p1, n1), cid(p1, n2)
            c21, c22 = cid(p2, n1), cid(p2, n2)
            isoq = (c11, c21, c22, c12)
            regions.append(([(p1, c11, c12), (p2, c21, c22),
                             (p1, p2, c21, c11), (p1, p2, c22, c12),
                             isoq], ref_out))
            regions.append(([(n1, c11, c21), (n2, c12, c22),
                             (n1, n2, c12, c11), (n1, n2, c22, c21),
                             isoq], ref_in))
            iso_tris.extend(_tri_quad(isoq))
        elif len(P) == 1 and len(N) == 2 and len(Z) == 1:
            p, (n1, n2), z = P[0], N, Z[0]
            c1, c2 = cid(p, n1), cid(p, n2)
            regions.append(([(p, c1, c2), (p, c1, z), (p, c2, z),
                             (c1, c2, z)], ref_out))
            regions.append(([(n1, n2, z), (n1, z, c1), (n2, z, c2),
                             (n1, n2, c2, c1), (c1, c2, z)], ref_in))
            iso_tris.append((c1, c2, z))
        elif len(N) == 1 and len(P) == 2 and len(Z) == 1:
            p, (n1, n2), z = N[0], P, Z[0]
            c1, c2 = cid(p, n1), cid(p, n2)
            regions.append(([(p, c1, c2), (p, c1, z), (p, c2, z),
                             (c1, c2, z)], ref_in))
            regions.append(([(n1, n2, z), (n1, z, c1), (n2, z, c2),
                             (n1, n2, c2, c1), (c1, c2, z)], ref_out))
            iso_tris.append((c1, c2, z))
        elif len(P) == 1 and len(N) == 1 and len(Z) == 2:
            p, n = P[0], N[0]
            z1, z2 = Z
            c = cid(p, n)
            regions.append(([(p, c, z1), (p, c, z2), (p, z1, z2),
                             (c, z1, z2)], ref_out))
            regions.append(([(n, c, z1), (n, c, z2), (n, z1, z2),
                             (c, z1, z2)], ref_in))
            iso_tris.append((c, z1, z2))
        else:  # unreachable given cut criterion + snapping
            raise AssertionError(f"unclassified cut pattern P{P} N{N} Z{Z}")

        for faces, ref in regions:
            for tt in _fan(faces):
                out_tets.append(tt)
                out_refs.append(ref)

    all_pts = np.concatenate([verts, new_pts], axis=0)
    out_tets = np.asarray(out_tets, np.int64)
    out_refs = np.asarray(out_refs, np.int64)
    # orient positively; drop degenerate slivers from snapped geometry
    c = all_pts[out_tets]
    vol = np.einsum(
        "ti,ti->t",
        np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]), c[:, 3] - c[:, 0],
    ) / 6.0
    flip = vol < 0
    out_tets[flip] = out_tets[flip][:, [0, 1, 3, 2]]
    good = np.abs(vol) > 1e-30
    out_tets, out_refs = out_tets[good], out_refs[good]

    # --- boundary trias: keep uncut, split cut ones 2D-conformally ---------
    trias, trrefs, trtags = d["trias"], d["trrefs"], d["trtags"]
    out_tris, out_trefs, out_ttags = [], [], []
    for fi in range(len(trias)):
        tv = [int(x) for x in trias[fi]]
        s3 = [int(sgn[x]) for x in tv]
        if min(s3) >= 0 or max(s3) <= 0:  # uncut
            out_tris.append(tuple(tv))
            out_trefs.append(int(trrefs[fi]))
            out_ttags.append(int(trtags[fi]))
            continue
        P = [x for x in tv if sgn[x] > 0]
        N = [x for x in tv if sgn[x] < 0]
        Z = [x for x in tv if sgn[x] == 0]
        if len(Z) == 1:  # one cut edge through the zero vertex
            p, n, z = P[0], N[0], Z[0]
            cc = cid(p, n)
            subs = [(p, cc, z), (n, cc, z)]
        else:  # 1 vs 2: one tri + one quad
            if len(P) == 1:
                a, (b1, b2) = P[0], N
            else:
                a, (b1, b2) = N[0], P
            c1, c2 = cid(a, b1), cid(a, b2)
            subs = [(a, c1, c2)] + _tri_quad((b1, b2, c2, c1))
        for tri in subs:
            out_tris.append(tuple(tri))
            out_trefs.append(int(trrefs[fi]))
            out_ttags.append(int(trtags[fi]))
    # isosurface trias
    for tri in iso_tris:
        out_tris.append(tuple(tri))
        out_trefs.append(ref_iso)
        out_ttags.append(tags.BDY | tags.REF)

    # drop sub-trias whose owner sub-tet was discarded as a degenerate
    # sliver above: a boundary tria with no adjacent tet face would make
    # tria_normals fall back to stored winding and could misclassify the
    # patch during feature detection
    out_tris_a = np.asarray(out_tris, np.int64).reshape(-1, 3)
    out_trefs_a = np.asarray(out_trefs, np.int64)
    out_ttags_a = np.asarray(out_ttags, np.int64)
    if len(out_tris_a):
        from ..utils.rows import row_member

        fkeys = np.sort(
            out_tets[:, np.asarray(FACE_VERTS)].reshape(-1, 3), axis=1
        )
        keep = row_member(np.sort(out_tris_a, axis=1), fkeys)
        out_tris_a = out_tris_a[keep]
        out_trefs_a = out_trefs_a[keep]
        out_ttags_a = out_ttags_a[keep]

    # --- vertex data -------------------------------------------------------
    def cat(name, newvals):
        return np.concatenate([d[name], newvals], axis=0)

    ls_new = np.full((len(new_pts), 1), isovalue)
    met = cat("met", lerp(d["met"]))
    fields = cat("fields", lerp(d["fields"])) if d["fields"].shape[1] else None
    disp = cat("disp", lerp(d["disp"])) if d["disp"].shape[1] else None
    vtags = np.concatenate(
        [d["vtags"], np.zeros(len(new_pts), np.int32)]
    )

    return Mesh.from_numpy(
        all_pts, out_tets, trefs=out_refs,
        vrefs=cat("vrefs", np.zeros(len(new_pts), np.int32)),
        vtags=vtags,
        trias=out_tris_a,
        trrefs=out_trefs_a,
        trtags=out_ttags_a,
        edges=d["edges"], edrefs=d["edrefs"], edtags=d["edtags"],
        met=met,
        ls=np.concatenate([d["ls"] - 0.0, ls_new]),
        disp=disp, fields=fields, field_ncomp=d["field_ncomp"],
        dtype=mesh.dtype, device=mesh.device,
    )
