"""Medit (.mesh/.sol) ASCII I/O for centralized meshes.

Counterpart of the host parts of `parmmg_tpu/io/medit.py`: a pure-Python
tokenizer, section reshapes in numpy, and write-then-rename publication.
Binary Medit files and the distributed per-shard files (parallel
communicator sections) come with the distributed slice of the port
(ROADMAP queue 1, item 12) and are refused here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core import tags
from ..core.mesh import Mesh

_COMMENT_RE = re.compile(r"#[^\n]*")

# unique per-call tmp suffix (pid plus a counter)
_TMP_SEQ = itertools.count()


@contextlib.contextmanager
def atomic_replace(path: str, mode: str = "w"):
    """Write-then-rename file publication: the payload goes to a
    same-directory temp file and appears at `path` only via `os.replace`
    after a successful close (+fsync), so a killed run never leaves a
    truncated file behind."""
    tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_SEQ)}"
    f = open(tmp, mode)
    try:
        yield f
    except BaseException:
        f.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    else:
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)


# Medit sol type codes
SOL_SCALAR = 1
SOL_VECTOR = 2
SOL_TENSOR = 3
_SOL_NCOMP = {SOL_SCALAR: 1, SOL_VECTOR: 3, SOL_TENSOR: 6}

# sections: name -> (columns, has_ref)
_ENT_SECTIONS = {
    "Vertices": (3, True),
    "Tetrahedra": (4, True),
    "Triangles": (3, True),
    "Edges": (2, True),
    "Quadrilaterals": (4, True),
    "Corners": (1, False),
    "RequiredVertices": (1, False),
    "RequiredTriangles": (1, False),
    "RequiredEdges": (1, False),
    "Ridges": (1, False),
    "Normals": (3, False),
    "Tangents": (3, False),
    "NormalAtVertices": (2, False),
    "TangentAtVertices": (2, False),
}

_DISTRIBUTED_ONLY = (
    "ParallelTriangleCommunicators", "ParallelVertexCommunicators",
    "ParallelCommunicatorTriangles", "ParallelCommunicatorVertices",
)


def _refuse_binary(path: str) -> None:
    with open(path, "rb") as f:
        head = f.read(4)
    if len(head) == 4 and int.from_bytes(head, "little") in (1, 1 << 24):
        raise NotImplementedError(
            f"{path}: binary Medit files are not ported yet (ROADMAP "
            "queue 1, item 12 brings the binary and distributed I/O)"
        )


def _tokenize(path: str) -> List[str]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"mesh file not found: {path}")
    _refuse_binary(path)
    with open(path) as f:
        text = f.read()
    return _COMMENT_RE.sub(" ", text).split()


@dataclasses.dataclass
class RawMesh:
    """Host-side parsed mesh, 0-based indices."""

    verts: np.ndarray
    vrefs: np.ndarray
    tets: np.ndarray
    trefs: np.ndarray
    trias: np.ndarray
    trrefs: np.ndarray
    edges: np.ndarray
    edrefs: np.ndarray
    corners: np.ndarray
    req_verts: np.ndarray
    req_trias: np.ndarray
    req_edges: np.ndarray
    ridges: np.ndarray


def read_mesh(path: str) -> RawMesh:
    toks = _tokenize(path)
    n = len(toks)
    i = 0
    data: Dict[str, np.ndarray] = {}
    dim = 3
    while i < n:
        kw = toks[i]
        i += 1
        if kw == "End":
            break
        if kw == "MeshVersionFormatted":
            i += 1
        elif kw == "Dimension":
            dim = int(toks[i])
            i += 1
        elif kw in _ENT_SECTIONS:
            cols, has_ref = _ENT_SECTIONS[kw]
            if kw == "Vertices":
                cols = dim
            cnt = int(toks[i])
            i += 1
            w = cols + (1 if has_ref else 0)
            arr = np.array(toks[i: i + cnt * w],
                           dtype=np.float64).reshape(cnt, w)
            i += cnt * w
            data[kw] = arr
        elif kw in _DISTRIBUTED_ONLY:
            raise NotImplementedError(
                f"{path}: parallel communicator sections belong to the "
                "distributed input, not ported yet (ROADMAP queue 1, "
                "item 12)"
            )
        else:
            raise ValueError(f"unhandled Medit keyword {kw!r} in {path}")

    def ent(kw, cols):
        if kw not in data:
            return np.zeros((0, cols), np.int32), np.zeros(0, np.int32)
        a = data[kw]
        return (a[:, :cols].astype(np.int64).astype(np.int32) - 1,
                a[:, cols].astype(np.int32))

    def ids(kw):
        if kw not in data:
            return np.zeros(0, np.int32)
        return data[kw][:, 0].astype(np.int64).astype(np.int32) - 1

    verts = data.get("Vertices", np.zeros((0, dim + 1)))
    tets, trefs = ent("Tetrahedra", 4)
    trias, trrefs = ent("Triangles", 3)
    edges, edrefs = ent("Edges", 2)
    return RawMesh(
        verts=verts[:, :dim].astype(np.float64),
        vrefs=verts[:, dim].astype(np.int32),
        tets=tets, trefs=trefs, trias=trias, trrefs=trrefs,
        edges=edges, edrefs=edrefs,
        corners=ids("Corners"), req_verts=ids("RequiredVertices"),
        req_trias=ids("RequiredTriangles"), req_edges=ids("RequiredEdges"),
        ridges=ids("Ridges"),
    )


def read_sol(path: str) -> Tuple[np.ndarray, List[int]]:
    """Read SolAtVertices: (values [n, sum(ncomp)], type codes)."""
    toks = _tokenize(path)
    i = 0
    n = len(toks)
    while i < n and toks[i] != "SolAtVertices":
        if toks[i] == "Dimension":
            i += 1
        i += 1
    if i >= n:
        raise ValueError(f"no SolAtVertices section in {path}")
    i += 1
    nv = int(toks[i])
    i += 1
    nsol = int(toks[i])
    i += 1
    types = [int(toks[i + k]) for k in range(nsol)]
    i += nsol
    width = sum(_SOL_NCOMP[t] for t in types)
    vals = np.array(toks[i: i + nv * width],
                    dtype=np.float64).reshape(nv, width)
    return vals, types


def raw_to_mesh(raw: RawMesh, met: np.ndarray | None = None, **kw) -> Mesh:
    """Assemble a Mesh from a RawMesh, deriving tag bits from the
    required/corner/ridge sections. `device=` and `dtype=` pass through
    to `Mesh.from_numpy` (`device=None` = GPU)."""
    npo = len(raw.verts)
    vtags = np.zeros(npo, np.int32)
    vtags[raw.req_verts] |= tags.REQUIRED
    vtags[raw.corners] |= tags.CORNER | tags.REQUIRED
    trtags = np.zeros(len(raw.trias), np.int32)
    trtags[raw.req_trias] |= tags.REQUIRED
    edtags = np.zeros(len(raw.edges), np.int32)
    edtags[raw.req_edges] |= tags.REQUIRED
    edtags[raw.ridges] |= tags.RIDGE
    return Mesh.from_numpy(
        raw.verts, raw.tets, vrefs=raw.vrefs, trefs=raw.trefs,
        trias=raw.trias, trrefs=raw.trrefs, edges=raw.edges,
        edrefs=raw.edrefs, vtags=vtags, trtags=trtags, edtags=edtags,
        met=met, **kw,
    )


def load_mesh(path: str, metpath: str | None = None, **kw) -> Mesh:
    """Centralized load: mesh file plus optional metric sol file."""
    raw = read_mesh(path)
    met = None
    if metpath is not None:
        if not os.path.exists(metpath):
            raise FileNotFoundError(f"metric sol file not found: {metpath}")
        vals, types = read_sol(metpath)
        if types[0] not in (SOL_SCALAR, SOL_TENSOR):
            raise ValueError("metric sol must be scalar or symmetric tensor")
        met = vals[:, : _SOL_NCOMP[types[0]]]
    return raw_to_mesh(raw, met=met, **kw)


def _fmt_block(f, name: str, arr: np.ndarray, refs, one_based):
    cnt = arr.shape[0]
    if cnt == 0:
        return
    f.write(f"\n{name}\n{cnt}\n")
    if arr.dtype.kind in "iu":
        body = arr + (1 if one_based else 0)
        if refs is not None:
            body = np.concatenate([body, refs[:, None]], axis=1)
        np.savetxt(f, body, fmt="%d")
    else:
        cols = ["%.15g"] * arr.shape[1]
        if refs is not None:
            body = np.concatenate([arr, refs[:, None].astype(np.float64)],
                                  axis=1)
            np.savetxt(f, body, fmt=" ".join(cols + ["%d"]))
        else:
            np.savetxt(f, arr, fmt=" ".join(cols))


def _check_ascii(path: str) -> None:
    if os.path.splitext(path)[1] in (".meshb", ".solb"):
        raise NotImplementedError(
            f"{path}: binary Medit output is not ported yet (ROADMAP "
            "queue 1, item 12)"
        )


def save_mesh(mesh: Mesh, path: str) -> None:
    """Write a centralized Medit ASCII mesh (valid entities, compacted
    numbering, 1-based)."""
    _check_ascii(path)
    d = mesh.to_numpy()
    vt = d["vtags"]
    corners = np.nonzero(vt & tags.CORNER)[0]
    req = np.nonzero(
        ((vt & tags.REQUIRED) != 0) & ((vt & tags.CORNER) == 0)
    )[0]
    ridges = np.nonzero(d["edtags"] & tags.RIDGE)[0]
    req_ed = np.nonzero(d["edtags"] & tags.REQUIRED)[0]
    req_tr = np.nonzero(
        ((d["trtags"] & tags.REQUIRED) != 0)
        & ~tags.pure_interface_tria(d["trtags"])
    )[0]
    with atomic_replace(path, "w") as f:
        f.write("MeshVersionFormatted 2\n\nDimension 3\n")
        _fmt_block(f, "Vertices", d["verts"], d["vrefs"], True)
        _fmt_block(f, "Tetrahedra", d["tets"], d["trefs"], True)
        _fmt_block(f, "Triangles", d["trias"], d["trrefs"], True)
        _fmt_block(f, "Edges", d["edges"], d["edrefs"], True)
        for name, ids in (("Corners", corners), ("RequiredVertices", req),
                          ("Ridges", ridges), ("RequiredEdges", req_ed),
                          ("RequiredTriangles", req_tr)):
            _fmt_block(f, name, ids[:, None] + 1, None, False)
        f.write("\nEnd\n")


def save_sol(path: str, values: np.ndarray, types: Sequence[int],
             dim: int = 3) -> None:
    _check_ascii(path)
    values = np.asarray(values)
    with atomic_replace(path, "w") as f:
        f.write(f"MeshVersionFormatted 2\n\nDimension {dim}\n\n"
                "SolAtVertices\n")
        f.write(f"{values.shape[0]}\n{len(types)} "
                f"{' '.join(map(str, types))}\n")
        np.savetxt(f, values, fmt="%.15g")
        f.write("\nEnd\n")


def save_met(mesh: Mesh, path: str) -> None:
    d = mesh.to_numpy()
    t = SOL_TENSOR if mesh.aniso else SOL_SCALAR
    save_sol(path, d["met"], [t])


_NCOMP_SOL = {v: k for k, v in _SOL_NCOMP.items()}


def save_fields(mesh: Mesh, path: str) -> None:
    """Save the interpolated solution fields (`-field` output, the
    `PMMG_saveAllSols_centralized` role)."""
    d = mesh.to_numpy()
    types = [_NCOMP_SOL[nc] for nc in d["field_ncomp"]]
    save_sol(path, d["fields"], types)


def load_fields(path: str):
    """Read a solution-fields sol file: (values [n, sum(ncomp)], ncomp
    tuple) for Mesh.from_numpy's fields/field_ncomp."""
    vals, types = read_sol(path)
    return vals, tuple(_SOL_NCOMP[t] for t in types)


def met_filename(path: str) -> str:
    """Metric sol name next to a mesh path."""
    base, ext = os.path.splitext(path)
    return base + (".solb" if ext == ".meshb" else ".sol")
