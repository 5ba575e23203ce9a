"""Flat structure-of-arrays tetrahedral mesh on one device.

Counterpart of `parmmg_tpu/core/mesh.py`, slot for slot: fixed-capacity,
0-based tensors with validity masks, all on one explicit device.

Conventions (as in the JAX package):
 - vertex/tet/tria/edge slots are valid iff the mask bit is set; invalid
   slots hold arbitrary data and are never read unmasked;
 - `tet[:, i]` is the vertex opposite local face `i`;
 - `adja[t, f] = 4*t2 + f2` glues face `f` of tet `t` to face `f2` of
   tet `t2`; -1 marks a boundary (or unmatched) face;
 - `met` has 1 component (iso size h) or 6 (m11,m12,m13,m22,m23,m33).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import tags

FACE_VERTS = np.array(
    [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]], dtype=np.int32
)
EDGE_VERTS = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# the tensor leaves of a Mesh, in declaration order
LEAVES = (
    "vert", "vref", "vtag", "vmask", "tet", "tref", "tmask", "adja",
    "tria", "trref", "trtag", "trmask", "edge", "edref", "edtag", "edmask",
    "met", "ls", "disp", "fields", "vglob",
)

# fill value of each leaf's padding slots
_FILL = dict(
    vert=0.0, vref=0, vtag=0, vmask=False, tet=0, tref=0, tmask=False,
    adja=-1, tria=0, trref=0, trtag=0, trmask=False, edge=0, edref=0,
    edtag=0, edmask=False, met=1.0, ls=0.0, disp=0.0, fields=0.0, vglob=-1,
)
_FLOAT_LEAVES = ("vert", "met", "ls", "disp", "fields")
_BOOL_LEAVES = ("vmask", "tmask", "trmask", "edmask")


def _pad2(a: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _leaf_dtype(name: str, fdtype):
    if name in _FLOAT_LEAVES:
        return fdtype
    if name in _BOOL_LEAVES:
        return torch.bool
    return torch.int32


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh as fixed-capacity tensors on one device."""

    vert: torch.Tensor    # [PC, 3] float coords
    vref: torch.Tensor    # [PC] int32
    vtag: torch.Tensor    # [PC] int32 tag bitfield (tags.py)
    vmask: torch.Tensor   # [PC] bool
    tet: torch.Tensor     # [TC, 4] int32
    tref: torch.Tensor    # [TC] int32
    tmask: torch.Tensor   # [TC] bool
    adja: torch.Tensor    # [TC, 4] int32
    tria: torch.Tensor    # [FC, 3] int32
    trref: torch.Tensor   # [FC] int32
    trtag: torch.Tensor   # [FC] int32
    trmask: torch.Tensor  # [FC] bool
    edge: torch.Tensor    # [EC, 2] int32
    edref: torch.Tensor   # [EC] int32
    edtag: torch.Tensor   # [EC] int32
    edmask: torch.Tensor  # [EC] bool
    met: torch.Tensor     # [PC, 1|6]
    ls: torch.Tensor      # [PC, 0|1]
    disp: torch.Tensor    # [PC, 0|3]
    fields: torch.Tensor  # [PC, K]
    vglob: torch.Tensor   # [PC] int32 global vertex id (-1 = none)
    field_ncomp: Tuple[int, ...] = ()
    met_set: bool = False

    # --- capacities -------------------------------------------------------
    @property
    def pcap(self) -> int:
        return self.vert.shape[0]

    @property
    def tcap(self) -> int:
        return self.tet.shape[0]

    @property
    def fcap(self) -> int:
        return self.tria.shape[0]

    @property
    def ecap(self) -> int:
        return self.edge.shape[0]

    @property
    def dtype(self):
        return self.vert.dtype

    @property
    def device(self) -> torch.device:
        return self.vert.device

    # --- live counts (0-d tensors on the mesh device) ---------------------
    @property
    def npoin(self) -> torch.Tensor:
        return self.vmask.sum()

    @property
    def ntet(self) -> torch.Tensor:
        return self.tmask.sum()

    @property
    def ntria(self) -> torch.Tensor:
        return self.trmask.sum()

    @property
    def nedge(self) -> torch.Tensor:
        return self.edmask.sum()

    @property
    def aniso(self) -> bool:
        return self.met.shape[1] == 6

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_numpy(
        verts, tets, *, vrefs=None, trefs=None, trias=None, trrefs=None,
        edges=None, edrefs=None, vtags=None, trtags=None, edtags=None,
        met=None, ls=None, disp=None, fields=None,
        field_ncomp: Tuple[int, ...] = (), vglob=None,
        pcap=None, tcap=None, fcap=None, ecap=None,
        headroom: float = 1.5, dtype=torch.float32, device=None,
    ) -> "Mesh":
        """Build a Mesh from 0-based numpy arrays, padding to capacity.
        `device=None` means the GPU (raises without one)."""
        from .. import resolve_device

        device = resolve_device(device)
        npo, nte = len(verts), len(tets)
        trias = np.zeros((0, 3), np.int32) if trias is None else trias
        edges = np.zeros((0, 2), np.int32) if edges is None else edges
        ntr, ned = len(trias), len(edges)

        def cap(n, c, lo=8):
            return int(c) if c is not None else max(lo, int(np.ceil(n * headroom)))

        pc, tc = cap(npo, pcap), cap(nte, tcap)
        fc, ec = cap(ntr, fcap), cap(ned, ecap)

        def ints(n, given):
            if given is None:
                return np.zeros(n, np.int32)
            out = np.asarray(given, np.int32)
            if out.shape[0] != n:
                raise ValueError(
                    f"attribute length {out.shape[0]} != entity count {n}"
                )
            return out

        verts = np.asarray(verts, np.float64)
        mcomp = 1 if met is None else np.asarray(met).reshape(npo, -1).shape[1]
        if mcomp not in (1, 6):
            raise ValueError(f"metric must have 1 or 6 components, got {mcomp}")
        met_np = (np.ones((npo, 1)) if met is None
                  else np.asarray(met, np.float64).reshape(npo, mcomp))

        def sol(a):
            return (np.zeros((npo, 0)) if a is None
                    else np.asarray(a, np.float64).reshape(npo, -1))

        host = dict(
            vert=_pad2(verts, pc, 0.0),
            vref=_pad2(ints(npo, vrefs), pc, 0),
            vtag=_pad2(ints(npo, vtags), pc, 0),
            vmask=_pad2(np.ones(npo, bool), pc, False),
            tet=_pad2(np.asarray(tets, np.int32).reshape(-1, 4), tc, 0),
            tref=_pad2(ints(nte, trefs), tc, 0),
            tmask=_pad2(np.ones(nte, bool), tc, False),
            adja=np.full((tc, 4), -1, np.int32),
            tria=_pad2(np.asarray(trias, np.int32).reshape(-1, 3), fc, 0),
            trref=_pad2(ints(ntr, trrefs), fc, 0),
            trtag=_pad2(ints(ntr, trtags), fc, 0),
            trmask=_pad2(np.ones(ntr, bool), fc, False),
            edge=_pad2(np.asarray(edges, np.int32).reshape(-1, 2), ec, 0),
            edref=_pad2(ints(ned, edrefs), ec, 0),
            edtag=_pad2(ints(ned, edtags), ec, 0),
            edmask=_pad2(np.ones(ned, bool), ec, False),
            met=_pad2(met_np, pc, 1.0),
            ls=_pad2(sol(ls), pc, 0.0),
            disp=_pad2(sol(disp), pc, 0.0),
            fields=_pad2(sol(fields), pc, 0.0),
            vglob=_pad2(np.full(npo, -1, np.int32) if vglob is None
                        else np.asarray(vglob, np.int32), pc, -1),
        )
        return Mesh._from_host(host, device, dtype, tuple(field_ncomp),
                               met is not None)

    @staticmethod
    def _from_host(host: dict, device, dtype, field_ncomp, met_set):
        leaves = {
            k: torch.tensor(host[k], dtype=_leaf_dtype(k, dtype),
                            device=device)
            for k in LEAVES
        }
        return Mesh(**leaves, field_ncomp=tuple(field_ncomp),
                    met_set=bool(met_set))

    @staticmethod
    def from_jax_state(arrays: dict, device=None, dtype=None,
                       field_ncomp: Tuple[int, ...] = (),
                       met_set: bool = False) -> "Mesh":
        """The port's Mesh from the leaves of a JAX-package `Mesh` given as
        numpy arrays (same names, same slots): both sides then compute on
        the same state. The float dtype follows `arrays["vert"]` unless
        given."""
        from .. import resolve_device

        device = resolve_device(device)
        if dtype is None:
            dtype = (torch.float64 if np.asarray(arrays["vert"]).dtype
                     == np.float64 else torch.float32)
        return Mesh._from_host({k: np.asarray(arrays[k]) for k in LEAVES},
                               device, dtype, field_ncomp, met_set)

    def to_numpy_state(self) -> dict:
        """All leaves as numpy arrays, slot for slot (the inverse of
        `from_jax_state`)."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in LEAVES}

    # --- host-side extraction --------------------------------------------
    def to_numpy(self) -> dict:
        """Valid entities as compact 0-based numpy arrays, vertex ids
        renumbered to the compacted vertex order."""
        s = self.to_numpy_state()
        vmask, tmask = s["vmask"], s["tmask"]
        trmask, edmask = s["trmask"], s["edmask"]
        new_id = np.cumsum(vmask) - 1
        return dict(
            verts=s["vert"][vmask], vrefs=s["vref"][vmask],
            vtags=s["vtag"][vmask],
            tets=new_id[s["tet"][tmask]], trefs=s["tref"][tmask],
            trias=new_id[s["tria"][trmask]], trrefs=s["trref"][trmask],
            trtags=s["trtag"][trmask],
            edges=new_id[s["edge"][edmask]], edrefs=s["edref"][edmask],
            edtags=s["edtag"][edmask],
            met=s["met"][vmask], ls=s["ls"][vmask], disp=s["disp"][vmask],
            fields=s["fields"][vmask], vglob=s["vglob"][vmask],
            field_ncomp=self.field_ncomp,
        )

    # --- capacity management ---------------------------------------------
    def with_capacity(self, pcap=None, tcap=None, fcap=None,
                      ecap=None) -> "Mesh":
        """Grow (never shrink) capacities; new slots get the fill values."""
        caps = dict(p=max(self.pcap, pcap or 0), t=max(self.tcap, tcap or 0),
                    f=max(self.fcap, fcap or 0), e=max(self.ecap, ecap or 0))
        kind = dict(vert="p", vref="p", vtag="p", vmask="p", met="p",
                    ls="p", disp="p", fields="p", vglob="p", tet="t",
                    tref="t", tmask="t", adja="t", tria="f", trref="f",
                    trtag="f", trmask="f", edge="e", edref="e", edtag="e",
                    edmask="e")

        def grow(name):
            a = getattr(self, name)
            cap = caps[kind[name]]
            if a.shape[0] == cap:
                return a
            out = torch.full((cap,) + tuple(a.shape[1:]), _FILL[name],
                             dtype=a.dtype, device=a.device)
            out[: a.shape[0]] = a
            return out

        return dataclasses.replace(self, **{k: grow(k) for k in LEAVES})

    def replace(self, **kw) -> "Mesh":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "Mesh":
        """A deep copy of every leaf."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).clone() for k in LEAVES}
        )

    def to(self, device) -> "Mesh":
        """The same mesh with every leaf on `device`."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in LEAVES}
        )


def tet_volumes(mesh: Mesh) -> torch.Tensor:
    """Signed volumes of all tet slots ([TC], garbage where masked)."""
    from ..kernels.quality_k import vol_of

    return vol_of(mesh.vert, mesh.tet)


def _compact_impl(mesh: Mesh, aux=None):
    """Compaction core: drop vertices no valid tet/tria/edge references
    (unless REQUIRED) and move every entity class to an array prefix.
    `aux`, an optional [PC, ...] per-vertex array (the frontier masks),
    follows the same vertex renumbering (dropped vertices fall away, the
    tail is zeros). Returns (aux, mesh)."""
    from ..ops import common as _common

    pc = mesh.pcap
    used = torch.zeros(pc, dtype=torch.bool, device=mesh.device)
    used = _common.scatter(used, mesh.tet.reshape(-1),
                           mesh.tmask.repeat_interleave(4), "max")
    used = _common.scatter(used, mesh.tria.reshape(-1),
                           mesh.trmask.repeat_interleave(3), "max")
    used = _common.scatter(used, mesh.edge.reshape(-1),
                           mesh.edmask.repeat_interleave(2), "max")
    keep_v = mesh.vmask & (used | ((mesh.vtag & tags.REQUIRED) != 0))

    vpos = torch.cumsum(keep_v.to(torch.int64), 0) - 1
    vnew = torch.where(keep_v, vpos, 0).to(torch.int32)
    vidx = _common.unique_oob(keep_v, vpos, pc)

    def scat_v(a, fill):
        return _common.scatter(torch.full_like(a, fill), vidx, a)

    def compact_ent(conn, mask, extras, fills):
        n = conn.shape[0]
        pos = torch.cumsum(mask.to(torch.int64), 0) - 1
        idx = _common.unique_oob(mask, pos, n)
        new_conn = _common.scatter(
            torch.zeros_like(conn), idx, _common.take(vnew, conn)
        )
        new_mask = _common.scatter(torch.zeros_like(mask), idx, mask)
        new_extras = tuple(
            _common.scatter(torch.full_like(e, f), idx, e)
            for e, f in zip(extras, fills)
        )
        return new_conn, new_mask, new_extras

    tet, tmask, (tref,) = compact_ent(mesh.tet, mesh.tmask, (mesh.tref,),
                                      (0,))
    tria, trmask, (trref, trtag) = compact_ent(
        mesh.tria, mesh.trmask, (mesh.trref, mesh.trtag), (0, 0)
    )
    edge, edmask, (edref, edtag) = compact_ent(
        mesh.edge, mesh.edmask, (mesh.edref, mesh.edtag), (0, 0)
    )
    aux_out = None if aux is None else _common.scatter(
        torch.zeros_like(aux), vidx, aux)
    return aux_out, mesh.replace(
        vert=scat_v(mesh.vert, 0.0), vref=scat_v(mesh.vref, 0),
        vtag=scat_v(mesh.vtag, 0), vmask=scat_v(keep_v, False),
        met=scat_v(mesh.met, 1.0), ls=scat_v(mesh.ls, 0.0),
        disp=scat_v(mesh.disp, 0.0), fields=scat_v(mesh.fields, 0.0),
        vglob=scat_v(mesh.vglob, -1),
        tet=tet, tmask=tmask, tref=tref,
        adja=torch.full_like(mesh.adja, -1),
        tria=tria, trmask=trmask, trref=trref, trtag=trtag,
        edge=edge, edmask=edmask, edref=edref, edtag=edtag,
    )


def compact(mesh: Mesh) -> Mesh:
    """Compact valid entities to array prefixes and drop unreferenced
    vertices (the batched `PMMG_packParMesh` analog)."""
    return _compact_impl(mesh)[1]


def compact_aux(mesh: Mesh, aux):
    """`compact` that also remaps an auxiliary per-vertex array (the
    frontier masks) through the same vertex renumbering. Returns (mesh,
    aux)."""
    aux_out, out = _compact_impl(mesh, aux)
    return out, aux_out
