"""Medit (.mesh/.sol, .meshb/.solb) I/O, centralized and distributed.

Counterpart of the host parts of `parmmg_tpu/io/medit.py`: the native
tokenizer for ASCII files (`native_io`, built at first use) or, where it
does not build, a pure-Python one, a GMF reader and writer for binary ones
(versions 1-3 read in either byte order, version 2 written), section
reshapes in numpy shared by both encodings, and write-then-rename
publication. Per-shard files `name.<rank>.mesh` carry the parallel
interface as `ParallelVertexCommunicators` / `ParallelTriangle
Communicators` sections of (local id, global id, communicator index)
triples (`save_mesh_distributed`, `load_mesh_distributed`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

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

def _tokenize(path: str) -> List[str]:
    from . import native_io

    if not os.path.exists(path):
        raise FileNotFoundError(f"mesh file not found: {path}")
    if native_io.available():
        return native_io.tokenize(path)
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
    # distributed interface info (None for centralized files): one
    # (color, local ids, global ids) triple per communicator
    face_comms: List[Tuple[int, np.ndarray, np.ndarray]] | None = None
    node_comms: List[Tuple[int, np.ndarray, np.ndarray]] | None = None


# ---------------------------------------------------------------------------
# binary Medit (.meshb / .solb)
#
# GMF container: int32 cookie 1 (16777216 when byte-swapped), int32
# version, then keyword records [code, NulPos, payload] where NulPos is
# the byte offset of the next record, so unknown sections are skipped by
# seeking to it. Version 2 (float64 reals, int32 ints and positions) is
# what is written; version 1 (float32 reals) and 3 (int64 positions) are
# read too. The communicator sections use ParMmg's codes 70-73.
# ---------------------------------------------------------------------------

_KWD_CODES = {
    "Dimension": 3,
    "Vertices": 4,
    "Edges": 5,
    "Triangles": 6,
    "Quadrilaterals": 7,
    "Tetrahedra": 8,
    "Corners": 13,
    "Ridges": 14,
    "RequiredVertices": 15,
    "RequiredEdges": 16,
    "RequiredTriangles": 17,
    "NormalAtVertices": 20,
    "End": 54,
    "Tangents": 59,
    "Normals": 60,
    "TangentAtVertices": 61,
    "SolAtVertices": 62,
    "ParallelTriangleCommunicators": 70,
    "ParallelVertexCommunicators": 71,
    "ParallelCommunicatorTriangles": 72,
    "ParallelCommunicatorVertices": 73,
}
_KWD_NAMES = {v: k for k, v in _KWD_CODES.items()}

# communicator sections: header (color, count per communicator) and
# items (local id, global id, communicator index)
_COMM_HEADS = ("ParallelTriangleCommunicators",
               "ParallelVertexCommunicators")
_COMM_ITEMS = {"ParallelCommunicatorTriangles":
               "ParallelTriangleCommunicators",
               "ParallelCommunicatorVertices":
               "ParallelVertexCommunicators"}


def is_binary_file(path: str) -> bool:
    """Sniff the GMF binary cookie (int32 1, either byte order), so a
    misnamed file still loads."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"mesh file not found: {path}")
    with open(path, "rb") as f:
        head = f.read(4)
    if len(head) < 4:
        return False
    return int(np.frombuffer(head, "<i4")[0]) in (1, 16777216)


class _BinReader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.path = path
        cookie = int(np.frombuffer(self.buf, "<i4", 1)[0])
        if cookie == 1:
            self.end = "<"
        elif cookie == 16777216:
            self.end = ">"
        else:
            raise ValueError(f"{path}: not a GMF binary file")
        self.ver = int(np.frombuffer(self.buf, self.end + "i4", 1, 4)[0])
        if self.ver not in (1, 2, 3):
            raise ValueError(
                f"{path}: unsupported GMF version {self.ver} "
                "(1-3 readable, 2 written)"
            )
        self.real = self.end + ("f4" if self.ver == 1 else "f8")
        self.int = self.end + "i4"
        self.pos_t = self.end + ("i8" if self.ver >= 3 else "i4")
        self.off = 8

    def ints(self, n):
        out = np.frombuffer(self.buf, self.int, n, self.off).astype(np.int64)
        self.off += 4 * n
        return out

    def int1(self):
        return int(self.ints(1)[0])

    def pos(self):
        v = int(np.frombuffer(self.buf, self.pos_t, 1, self.off)[0])
        self.off += np.dtype(self.pos_t).itemsize
        return v

    def table(self, cnt, ncols_real=0, ncols_int=0):
        """cnt rows of (reals..., ints...) as a float64 [cnt, ncols]
        array, the form the ASCII sections parse to."""
        dt = np.dtype(
            ([("r", np.dtype(self.real), (ncols_real,))] if ncols_real
             else [])
            + ([("i", self.int, (ncols_int,))] if ncols_int else [])
        )
        arr = np.frombuffer(self.buf, dt, cnt, self.off)
        self.off += dt.itemsize * cnt
        parts = []
        if ncols_real:
            parts.append(arr["r"].astype(np.float64))
        if ncols_int:
            parts.append(arr["i"].astype(np.float64))
        return np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]


def _read_sections_binary(path: str):
    r = _BinReader(path)
    data: Dict[str, np.ndarray] = {}
    comm_heads: Dict[str, np.ndarray] = {}
    comm_items: Dict[str, np.ndarray] = {}
    dim = 3
    n = len(r.buf)
    while r.off + 4 <= n:
        code = r.int1()
        if code == _KWD_CODES["End"]:
            break
        nxt = r.pos()
        name = _KWD_NAMES.get(code)
        if name is None:
            if nxt <= r.off:
                # a broken skip chain is a truncated or corrupt file
                raise ValueError(
                    f"{path}: malformed GMF record chain at byte "
                    f"{r.off} (keyword code {code}, next={nxt}) — "
                    "truncated or corrupt binary mesh"
                )
            r.off = nxt
            continue
        if name == "Dimension":
            dim = r.int1()
        elif name in _ENT_SECTIONS:
            cols, has_ref = _ENT_SECTIONS[name]
            if name == "Vertices":
                cols = dim
            cnt = r.int1()
            if name in ("Vertices", "Normals", "Tangents"):
                data[name] = r.table(cnt, ncols_real=cols,
                                     ncols_int=1 if has_ref else 0)
            else:
                data[name] = r.table(cnt,
                                     ncols_int=cols + (1 if has_ref else 0))
        elif name in _COMM_HEADS:
            cnt = r.int1()
            comm_heads[name] = r.ints(cnt * 2).reshape(cnt, 2)
        elif name in _COMM_ITEMS:
            head_kw = _COMM_ITEMS[name]
            if head_kw not in comm_heads:
                raise ValueError(
                    f"{path}: section {name} appears before its header "
                    f"section {head_kw}"
                )
            ntot = int(comm_heads[head_kw][:, 1].sum())
            comm_items[name] = r.ints(ntot * 3).reshape(ntot, 3)
        if nxt > 0:
            r.off = nxt  # the skip chain over our own arithmetic
    return data, comm_heads, comm_items, dim


class _BinWriter:
    """GMF version-2 writer (float64 reals, int32 ints and positions).
    Writes to a temp file; `end()` publishes it atomically, `abort()`
    discards it, so the target path is never seen half-written."""

    def __init__(self, path: str):
        self.path = path
        self.tmp = f"{path}.tmp.{os.getpid()}"
        self.f = open(self.tmp, "wb")
        self.f.write(np.array([1, 2], "<i4").tobytes())

    def _i4(self, *vals):
        self.f.write(np.array(vals, "<i4").tobytes())

    def section(self, name: str, payload: bytes, head: Sequence[int]):
        """[code, NulPos, head ints..., payload]."""
        here = self.f.tell()
        nxt = here + 8 + 4 * len(head) + len(payload)
        if nxt > 2**31 - 1:
            raise ValueError(
                "mesh too large for GMF version 2 int32 positions "
                f"(section {name} would end at byte {nxt}); write ASCII "
                "or shard the mesh"
            )
        self._i4(_KWD_CODES[name], nxt, *head)
        self.f.write(payload)

    def end(self):
        self._i4(_KWD_CODES["End"], 0)
        self.f.flush()
        os.fsync(self.f.fileno())
        self.f.close()
        os.replace(self.tmp, self.path)

    def abort(self):
        if not self.f.closed:
            self.f.close()
        try:
            os.unlink(self.tmp)
        except OSError:
            pass


def _rows_bytes(arr_i: np.ndarray, refs: np.ndarray | None,
                one_based: bool) -> bytes:
    body = arr_i.astype(np.int32) + (1 if one_based else 0)
    if refs is not None:
        body = np.concatenate([body, refs.astype(np.int32)[:, None]], axis=1)
    return np.ascontiguousarray(body, "<i4").tobytes()


def _save_mesh_binary(path: str, d: Dict[str, np.ndarray],
                      comm_sections) -> None:
    w = _BinWriter(path)
    try:
        _save_mesh_binary_inner(w, d, comm_sections)
    except BaseException:
        w.abort()
        raise


def _save_mesh_binary_inner(w: _BinWriter, d: Dict[str, np.ndarray],
                            comm_sections) -> None:
    w.section("Dimension", b"", [3])
    verts = np.zeros(len(d["verts"]),
                     np.dtype([("xyz", "<f8", (3,)), ("ref", "<i4")]))
    verts["xyz"] = d["verts"]
    verts["ref"] = d["vrefs"]
    w.section("Vertices", verts.tobytes(), [len(verts)])
    for name, key, rkey in (("Tetrahedra", "tets", "trefs"),
                            ("Triangles", "trias", "trrefs"),
                            ("Edges", "edges", "edrefs")):
        if len(d[key]):
            w.section(name, _rows_bytes(d[key], d[rkey], True),
                      [len(d[key])])
    for name, ids in d["idsections"]:
        if len(ids):
            w.section(name, _rows_bytes(ids[:, None], None, True),
                      [len(ids)])
    for kw_head, kw_items, remapped in comm_sections:
        w.section(kw_head, np.ascontiguousarray(
            [[c, len(loc)] for c, loc, _ in remapped], "<i4").tobytes(),
            [len(remapped)])
        items = np.concatenate([
            np.stack([np.asarray(loc, np.int64) + 1,
                      np.asarray(glob, np.int64),
                      np.full(len(loc), icomm, np.int64)], axis=1)
            for icomm, (c, loc, glob) in enumerate(remapped)])
        w.section(kw_items, np.ascontiguousarray(items, "<i4").tobytes(), [])
    w.end()


def read_mesh(path: str) -> RawMesh:
    """Parse a Medit mesh, ASCII or binary (sniffed from the content),
    with its communicator sections when it has them."""
    if is_binary_file(path):
        return _assemble_raw(*_read_sections_binary(path), path)
    toks = _tokenize(path)
    n = len(toks)
    i = 0
    data: Dict[str, np.ndarray] = {}
    comm_heads: Dict[str, np.ndarray] = {}
    comm_items: Dict[str, np.ndarray] = {}
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
        elif kw in _COMM_HEADS:
            cnt = int(toks[i])
            i += 1
            comm_heads[kw] = np.array(toks[i: i + cnt * 2],
                                      dtype=np.int64).reshape(cnt, 2)
            i += cnt * 2
        elif kw in _COMM_ITEMS:
            head_kw = _COMM_ITEMS[kw]
            if head_kw not in comm_heads:
                raise ValueError(
                    f"{path}: section {kw} appears before its header "
                    f"section {head_kw}"
                )
            ntot = int(comm_heads[head_kw][:, 1].sum())
            comm_items[kw] = np.array(toks[i: i + ntot * 3],
                                      dtype=np.int64).reshape(ntot, 3)
            i += ntot * 3
        else:
            raise ValueError(f"unhandled Medit keyword {kw!r} in {path}")
    return _assemble_raw(data, comm_heads, comm_items, dim, path)


def _assemble_raw(data: Dict[str, np.ndarray],
                  comm_heads: Dict[str, np.ndarray],
                  comm_items: Dict[str, np.ndarray], dim: int,
                  path: str) -> RawMesh:
    """Section dicts -> RawMesh: the shared back half of the ASCII and
    binary readers."""

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

    def build_comms(head_kw, item_kw):
        if head_kw not in comm_heads:
            return None
        head = comm_heads[head_kw]
        if item_kw not in comm_items:
            raise ValueError(
                f"{path}: header section {head_kw} present but item "
                f"section {item_kw} missing"
            )
        items = comm_items[item_kw]
        out = []
        for icomm in range(head.shape[0]):
            sel = items[:, 2] == icomm
            out.append((int(head[icomm, 0]),
                        items[sel, 0].astype(np.int32) - 1,
                        items[sel, 1].astype(np.int32)))
        return out

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
        face_comms=build_comms("ParallelTriangleCommunicators",
                               "ParallelCommunicatorTriangles"),
        node_comms=build_comms("ParallelVertexCommunicators",
                               "ParallelCommunicatorVertices"),
    )


def read_sol(path: str) -> Tuple[np.ndarray, List[int]]:
    """Read SolAtVertices, ASCII or binary: (values [n, sum(ncomp)],
    type codes)."""
    if is_binary_file(path):
        r = _BinReader(path)
        n = len(r.buf)
        while r.off + 4 <= n:
            code = r.int1()
            if code == _KWD_CODES["End"]:
                break
            nxt = r.pos()
            if code == _KWD_CODES["Dimension"]:
                r.int1()
            elif code == _KWD_CODES["SolAtVertices"]:
                nv = r.int1()
                nsol = r.int1()
                types = [int(t) for t in r.ints(nsol)]
                width = sum(_SOL_NCOMP[t] for t in types)
                return r.table(nv, ncols_real=width), types
            if nxt > 0:
                r.off = nxt
        raise ValueError(f"no SolAtVertices section in {path}")
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


def _is_binary_name(path: str) -> bool:
    return os.path.splitext(path)[1] in (".meshb", ".solb")


def save_mesh(mesh: Mesh, path: str, *,
              face_comms: Sequence[Tuple[int, np.ndarray, np.ndarray]]
              | None = None,
              node_comms: Sequence[Tuple[int, np.ndarray, np.ndarray]]
              | None = None) -> None:
    """Write a centralized or per-shard Medit mesh (valid entities,
    compacted numbering, 1-based), binary for a `.meshb` name. The
    communicators' local ids are mesh slots, remapped to the written
    numbering."""
    d = mesh.to_numpy()
    vt = d["vtags"]
    corners = np.nonzero(vt & tags.CORNER)[0]
    req = np.nonzero(
        ((vt & tags.REQUIRED) != 0) & ((vt & tags.CORNER) == 0)
    )[0]
    ridges = np.nonzero(d["edtags"] & tags.RIDGE)[0]
    req_ed = np.nonzero(d["edtags"] & tags.REQUIRED)[0]
    # pure synthetic interface trias stay out: their REQUIRED was added
    # by the split and comes back from the face-comm sections on load;
    # real-surface interface trias (PARBDYBDY) stay listed, which is how
    # the loader tells the two kinds apart
    req_tr = np.nonzero(
        ((d["trtags"] & tags.REQUIRED) != 0)
        & ~tags.pure_interface_tria(d["trtags"])
    )[0]
    d["idsections"] = [("Corners", corners), ("RequiredVertices", req),
                       ("Ridges", ridges), ("RequiredEdges", req_ed),
                       ("RequiredTriangles", req_tr)]
    tr_live = mesh.trmask.cpu().numpy()
    v_live = mesh.vmask.cpu().numpy()
    comm_sections = []
    for kw_head, kw_items, comms, live in (
        ("ParallelTriangleCommunicators", "ParallelCommunicatorTriangles",
         face_comms, tr_live),
        ("ParallelVertexCommunicators", "ParallelCommunicatorVertices",
         node_comms, v_live),
    ):
        if not comms:
            continue
        renum = np.cumsum(live) - 1
        remapped = []
        for color, loc, glob in comms:
            loc = np.asarray(loc)
            if not live[loc].all():
                raise ValueError(
                    f"communicator (color {color}) references deleted "
                    f"entities; cannot save"
                )
            remapped.append((color, renum[loc], np.asarray(glob)))
        comm_sections.append((kw_head, kw_items, remapped))

    if _is_binary_name(path):
        _save_mesh_binary(path, d, comm_sections)
        return
    with atomic_replace(path, "w") as f:
        f.write("MeshVersionFormatted 2\n\nDimension 3\n")
        _fmt_block(f, "Vertices", d["verts"], d["vrefs"], True)
        _fmt_block(f, "Tetrahedra", d["tets"], d["trefs"], True)
        _fmt_block(f, "Triangles", d["trias"], d["trrefs"], True)
        _fmt_block(f, "Edges", d["edges"], d["edrefs"], True)
        for name, ids in d["idsections"]:
            _fmt_block(f, name, ids[:, None] + 1, None, False)
        for kw_head, kw_items, remapped in comm_sections:
            f.write(f"\n{kw_head}\n{len(remapped)}\n")
            for color, loc, glob in remapped:
                f.write(f"{color} {len(loc)}\n")
            f.write(f"\n{kw_items}\n")
            for icomm, (color, loc, glob) in enumerate(remapped):
                for l, g in zip(loc, glob):
                    f.write(f"{l + 1} {g} {icomm}\n")
        f.write("\nEnd\n")


def save_sol(path: str, values: np.ndarray, types: Sequence[int],
             dim: int = 3) -> None:
    """Write SolAtVertices, binary for a `.solb` name."""
    values = np.asarray(values)
    if _is_binary_name(path):
        w = _BinWriter(path)
        try:
            w.section("Dimension", b"", [dim])
            payload = (np.array(types, "<i4").tobytes()
                       + np.ascontiguousarray(values, "<f8").tobytes())
            w.section("SolAtVertices", payload,
                      [values.shape[0], len(types)])
            w.end()
        except BaseException:
            w.abort()
            raise
        return
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


def shard_filename(path: str, rank: int) -> str:
    """`name.mesh -> name.<rank>.mesh`."""
    base, ext = os.path.splitext(path)
    return f"{base}.{rank}{ext}"


def met_filename(path: str) -> str:
    """Metric sol name next to a mesh path, in the mesh's encoding
    (`.meshb` -> `.solb`)."""
    base, ext = os.path.splitext(path)
    return base + (".solb" if ext == ".meshb" else ".sol")


def save_mesh_distributed(stacked: Mesh, comm, path: str,
                          with_met: bool = False) -> None:
    """Write per-shard `name.<rank>.mesh` files with the parallel
    interface as `ParallelVertexCommunicators` sections (colors are the
    neighbour shards, global ids from the `ShardComm`'s `l2g`), so that
    `load_mesh_distributed` restores an equivalent ShardComm. Interface
    trias carrying a split-added NOSURF (pure synthetic ones and
    real-surface PARBDYBDY replicas) are written as face-comm sections,
    which restore the PARBDY/NOSURF distinction a RequiredTriangles
    section cannot carry."""
    from ..parallel.distribute import unstack_mesh

    comm_idx = comm.comm_idx.cpu().numpy()
    counts = comm.counts.cpu().numpy()
    l2g = comm.l2g.cpu().numpy()
    D = comm_idx.shape[0]
    for s, m in enumerate(unstack_mesh(stacked)):
        node_comms = []
        for r in range(D):
            c = int(counts[s, r])
            if r == s or c == 0:
                continue
            loc = comm_idx[s, r, :c]
            node_comms.append((r, loc, l2g[s][loc]))
        trtag_s = m.trtag.cpu().numpy()
        syn = (m.trmask.cpu().numpy() & ((trtag_s & tags.PARBDY) != 0)
               & ((trtag_s & tags.NOSURF) != 0))
        tria_ids = np.nonzero(syn)[0]
        face_comms = []
        if len(tria_ids):
            member = np.zeros((l2g.shape[1], D), bool)
            for r in range(D):
                c = int(counts[s, r])
                if r != s and c:
                    member[comm_idx[s, r, :c], r] = True
            tv = m.tria.cpu().numpy()[tria_ids]
            # the neighbour sharing all three vertices (a synthetic tria
            # is a tet face between two shards); argmax falls back to 0,
            # which the loader does not read (it unions the lists)
            color = np.argmax(member[tv].all(axis=1), axis=1)
            for r in np.unique(color):
                sel = color == r
                face_comms.append(
                    (int(r), tria_ids[sel],
                     np.zeros(int(sel.sum()), np.int64)))
        save_mesh(m, shard_filename(path, s), node_comms=node_comms,
                  face_comms=face_comms or None)
        if with_met:
            save_met(m, met_filename(shard_filename(path, s)))


def load_mesh_distributed(path: str, nparts: int, metpath: str | None = None,
                          **kw):
    """Read per-shard `name.<rank>.mesh` files (and per-shard metric
    sols `metpath.<rank>.sol`) into (stacked Mesh, ShardComm).
    `device=` and `dtype=` pass through to
    `parallel.distribute.stack_loaded_shards`."""
    from ..parallel.distribute import stack_loaded_shards

    raws = [read_mesh(shard_filename(path, s)) for s in range(nparts)]
    stacked, comm = stack_loaded_shards(raws, **kw)
    if metpath is not None:
        mets = []
        for s in range(nparts):
            vals, types = read_sol(shard_filename(metpath, s))
            ncomp = _SOL_NCOMP[types[0]]
            met = np.ones((stacked.met.shape[1], ncomp))
            met[: len(vals)] = vals[:, :ncomp]
            mets.append(met)
        stacked = stacked.replace(
            met=torch.as_tensor(np.stack(mets), dtype=stacked.dtype,
                                device=stacked.device),
            met_set=True)
    return stacked, comm
