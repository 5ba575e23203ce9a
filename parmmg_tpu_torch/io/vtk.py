"""VTK XML I/O: centralized `.vtu` and distributed `.pvtu`, ASCII.

Counterpart of `parmmg_tpu/io/vtk.py`, on the host in numpy through
`Mesh.to_numpy`: the XML is emitted directly (inline ASCII data arrays)
and is byte for byte what the JAX package writes. Metric, level-set,
displacement and user fields are written as PointData.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.mesh import Mesh

_VTK_TETRA = 10
_VTK_TRIANGLE = 5


def _data_array(f, name: str, arr: np.ndarray, indent: str = "        "):
    arr = np.asarray(arr)
    ncomp = 1 if arr.ndim == 1 else arr.shape[1]
    if arr.dtype.kind in "iu":
        typ, fmt = "Int64", "%d"
    else:
        typ, fmt = "Float64", "%.15g"
    f.write(
        f'{indent}<DataArray type="{typ}" Name="{name}" '
        f'NumberOfComponents="{ncomp}" format="ascii">\n'
    )
    np.savetxt(f, arr.reshape(-1, ncomp), fmt=fmt)
    f.write(f"{indent}</DataArray>\n")


def _point_data_fields(d) -> list:
    """(name, array) PointData entries from a to_numpy dict."""
    out = []
    met = d["met"]
    if met.size:
        out.append(("metric" if met.shape[1] > 1 else "h", met))
    if d["ls"].shape[1]:
        out.append(("ls", d["ls"]))
    if d["disp"].shape[1]:
        out.append(("disp", d["disp"]))
    if d["fields"].shape[1]:
        off = 0
        for k, nc in enumerate(d["field_ncomp"]):
            out.append((f"field{k}", d["fields"][:, off:off + nc]))
            off += nc
    out.append(("ref", d["vrefs"]))
    return out


def save_vtu(mesh: Mesh, path: str) -> None:
    """Write one shard/mesh as an ASCII `.vtu` unstructured grid
    (tetra cells + boundary-triangle cells)."""
    d = mesh.to_numpy()
    npts = len(d["verts"])
    cells = [d["tets"], d["trias"]]
    ctypes = np.concatenate([
        np.full(len(d["tets"]), _VTK_TETRA, np.int64),
        np.full(len(d["trias"]), _VTK_TRIANGLE, np.int64),
    ])
    crefs = np.concatenate([d["trefs"], d["trrefs"]])
    conn = np.concatenate([c.reshape(-1) for c in cells])
    sizes = np.concatenate([
        np.full(len(d["tets"]), 4, np.int64),
        np.full(len(d["trias"]), 3, np.int64),
    ])
    offsets = np.cumsum(sizes)
    ncell = len(ctypes)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="UnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n  <UnstructuredGrid>\n'
        )
        f.write(
            f'    <Piece NumberOfPoints="{npts}" NumberOfCells="{ncell}">\n'
        )
        f.write("      <Points>\n")
        _data_array(f, "Points", d["verts"])
        f.write("      </Points>\n      <Cells>\n")
        _data_array(f, "connectivity", conn)
        _data_array(f, "offsets", offsets)
        _data_array(f, "types", ctypes)
        f.write("      </Cells>\n      <PointData>\n")
        for name, arr in _point_data_fields(d):
            _data_array(f, name, arr)
        f.write("      </PointData>\n      <CellData>\n")
        _data_array(f, "ref", crefs)
        f.write("      </CellData>\n    </Piece>\n")
        f.write("  </UnstructuredGrid>\n</VTKFile>\n")


def save_pvtu(stacked: Mesh, comm, path: str) -> None:
    """Parallel `.pvtu` master file + one `.vtu` piece per shard of a
    stacked mesh (`PMMG_savePvtuMesh` role). `comm` is not read."""
    from ..parallel.distribute import unstack_mesh

    base, ext = os.path.splitext(path)
    if ext != ".pvtu":
        base = path
    shards = unstack_mesh(stacked)
    pieces = []
    for s, m in enumerate(shards):
        piece = f"{os.path.basename(base)}_{s}.vtu"
        save_vtu(m, os.path.join(os.path.dirname(path) or ".", piece))
        pieces.append(piece)
    d0 = shards[0].to_numpy()
    with open(base + ".pvtu", "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="PUnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n'
            '  <PUnstructuredGrid GhostLevel="0">\n'
        )
        f.write("    <PPoints>\n")
        f.write(
            '      <PDataArray type="Float64" Name="Points" '
            'NumberOfComponents="3"/>\n'
        )
        f.write("    </PPoints>\n    <PPointData>\n")
        for name, arr in _point_data_fields(d0):
            a = np.asarray(arr)
            nc = 1 if a.ndim == 1 else a.shape[1]
            typ = "Int64" if a.dtype.kind in "iu" else "Float64"
            f.write(
                f'      <PDataArray type="{typ}" Name="{name}" '
                f'NumberOfComponents="{nc}"/>\n'
            )
        f.write("    </PPointData>\n    <PCellData>\n")
        f.write(
            '      <PDataArray type="Int64" Name="ref" '
            'NumberOfComponents="1"/>\n'
        )
        f.write("    </PCellData>\n")
        for piece in pieces:
            f.write(f'    <Piece Source="{piece}"/>\n')
        f.write("  </PUnstructuredGrid>\n</VTKFile>\n")


def load_vtu(path: str, **kw) -> Mesh:
    """Read an ASCII `.vtu` written by `save_vtu` (or a compatible ASCII
    file) back into a Mesh — the `PMMG_loadVtuMesh_centralized` role.
    Only the inline-ASCII subset is read; the metric is the only
    PointData taken. `device=` and `dtype=` pass through to
    `Mesh.from_numpy` (`device=None` = GPU)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    piece = root.find(".//Piece")

    def arr_of(parent, name):
        for da in parent.iter("DataArray"):
            if da.get("Name") == name:
                flat = np.array(da.text.split(), dtype=np.float64)
                nc = int(da.get("NumberOfComponents", "1"))
                return flat.reshape(-1, nc) if nc > 1 else flat
        return None

    pts = arr_of(piece.find("Points"), "Points")
    cells = piece.find("Cells")
    conn = arr_of(cells, "connectivity").astype(np.int64)
    types = arr_of(cells, "types").astype(np.int64)
    offsets = arr_of(cells, "offsets").astype(np.int64)
    starts = np.concatenate([[0], offsets[:-1]])
    tets, trias = [], []
    for t, s, e in zip(types, starts, offsets):
        if t == _VTK_TETRA:
            tets.append(conn[s:e])
        elif t == _VTK_TRIANGLE:
            trias.append(conn[s:e])
    pd = piece.find("PointData")
    met = None
    if pd is not None:
        m = arr_of(pd, "metric")
        h = arr_of(pd, "h")
        met = m if m is not None else (h[:, None] if h is not None else None)
    return Mesh.from_numpy(
        pts,
        np.array(tets, np.int64).reshape(-1, 4),
        trias=(np.array(trias, np.int64).reshape(-1, 3) if trias else None),
        met=met, **kw,
    )
