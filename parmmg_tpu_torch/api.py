"""Library API: the parameter enum and the `ParMesh` setter / run /
getter surface.

Counterpart of `parmmg_tpu/api.py` (the reference's `PMMG_Init_parMesh`
/ `PMMG_Set_*` / `PMMG_parmmglib_centralized` / `PMMG_Get_*` layer): the
setters stage 0-based numpy arrays, `parmmglib_centralized()` /
`parmmglib_distributed()` build the port's `Mesh` on the ParMesh's
device and run the drivers there, and the getters return numpy arrays.
The device is resolved when the ParMesh is built (default: the GPU,
which raises there when none is present).

A staged mesh is built at float32 with capacities 1.5x its counts
(`Mesh.from_numpy`'s defaults), as in the JAX package. Entity indices
are 0-based; the C ABI (`capi_support.py`, `native/parmmg_capi.c`)
takes and returns them 1-based.

`set_checkpoint` is refused (`NotImplementedError`): checkpoint and
resume are ROADMAP queue 1, item 15.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import resolve_device
from .core import tags
from .core.mesh import Mesh
from .core.tags import APIDistrib, ReturnStatus
from .models.adapt import AdaptOptions
from .models.distributed import DistOptions


class Param(enum.IntEnum):
    """`PMMG_Param` equivalents (reference `src/libparmmg.h:54-90`), with
    the JAX package's numbering."""

    # integer parameters
    IPARAM_verbose = 0
    IPARAM_mem = 1
    IPARAM_debug = 2
    IPARAM_angle = 3          # enable angle detection (1) or not (0)
    IPARAM_iso = 4            # level-set discretization mode
    IPARAM_opnbdy = 5
    IPARAM_optim = 6
    IPARAM_optimLES = 7
    IPARAM_nofem = 8
    IPARAM_noinsert = 9
    IPARAM_noswap = 10
    IPARAM_nomove = 11
    IPARAM_nosurf = 12
    IPARAM_anisosize = 13
    IPARAM_octree = 14
    IPARAM_meshSize = 15      # remesher target mesh size
    IPARAM_nobalancing = 16
    IPARAM_metisRatio = 17
    IPARAM_ifcLayers = 18
    IPARAM_groupsRatio = 19
    IPARAM_APImode = 20
    IPARAM_globalNum = 21
    IPARAM_niter = 22
    IPARAM_distributedOutput = 23
    IPARAM_nparts = 24        # shard count
    # lagrangian motion: present so that callers get the reference's
    # clean rejection (src/libparmmg.c:69-73)
    IPARAM_lag = 25
    # double parameters
    DPARAM_angleDetection = 32
    DPARAM_hmin = 33
    DPARAM_hmax = 34
    DPARAM_hsiz = 35
    DPARAM_hausd = 36
    DPARAM_hgrad = 37
    DPARAM_hgradreq = 38
    DPARAM_ls = 39
    # closed-loop balance band (max/mean measured work above which the
    # balancer forces a re-cut; <= 0 disables)
    DPARAM_balanceBand = 40


_SOL_SIZES = {"scalar": 1, "vector": 3, "tensor": 6}


@dataclasses.dataclass
class _Staging:
    """Host-side entity staging (the MMG5_Mesh-filling role of
    `MMG3D_Set_vertex` etc.)."""

    verts: Optional[np.ndarray] = None
    vrefs: Optional[np.ndarray] = None
    tets: Optional[np.ndarray] = None
    trefs: Optional[np.ndarray] = None
    trias: Optional[np.ndarray] = None
    trrefs: Optional[np.ndarray] = None
    edges: Optional[np.ndarray] = None
    edrefs: Optional[np.ndarray] = None
    corners: List[int] = dataclasses.field(default_factory=list)
    req_verts: List[int] = dataclasses.field(default_factory=list)
    req_trias: List[int] = dataclasses.field(default_factory=list)
    req_edges: List[int] = dataclasses.field(default_factory=list)
    ridges: List[int] = dataclasses.field(default_factory=list)
    met: Optional[np.ndarray] = None
    ls: Optional[np.ndarray] = None
    disp: Optional[np.ndarray] = None
    fields: List[np.ndarray] = dataclasses.field(default_factory=list)


class ParMesh:
    """The `PMMG_ParMesh` role: staged mesh, parameters and results.

    Centralized flow (the reference's
    `libexamples/adaptation_example0/sequential_IO/manual_IO/main.c`):

        pm = ParMesh()                      # device=None: the GPU
        pm.set_mesh_size(np_=..., ne=..., nt=...)
        pm.set_vertices(coords, refs)
        pm.set_tetrahedra(tets, refs)
        pm.set_metric_sols(h)
        pm.set_dparameter(Param.DPARAM_hsiz, 0.05)
        assert pm.parmmglib_centralized() == ReturnStatus.SUCCESS
        verts, tets = pm.get_vertices()[0], pm.get_tetrahedra()[0]
    """

    def __init__(self, nparts: int = 1, device=None):
        self.device = resolve_device(device)
        self.stage = _Staging()
        self.opts = DistOptions(nparts=nparts)
        self.iparam: Dict[Param, int] = {}
        self.dparam: Dict[Param, float] = {}
        self.api_mode = APIDistrib.UNSET
        # distributed-API interface staging: (color, local_ids,
        # global_ids) per communicator
        self._node_comms: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self._face_comms: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.mesh: Optional[Mesh] = None      # result (centralized view)
        self.stacked: Optional[Mesh] = None   # result (distributed view)
        self.comm = None                      # ShardComm of the result
        self.info: dict = {}
        self.status = ReturnStatus.SUCCESS

    # --- sizes ------------------------------------------------------------
    def set_mesh_size(self, np_: int = 0, ne: int = 0, nt: int = 0,
                      na: int = 0):
        """`PMMG_Set_meshSize`: the entity counts (np vertices, ne tetra,
        nt triangles, na edges) the by-index setters fill."""
        self._declared = (np_, ne, nt, na)
        return ReturnStatus.SUCCESS

    def get_mesh_size(self):
        m = self._result_mesh()
        return (int(m.npoin), int(m.ntet), int(m.ntria), int(m.nedge))

    # --- entity setters (bulk and by index) -------------------------------
    def set_vertices(self, coords, refs=None):
        coords = np.asarray(coords, np.float64).reshape(-1, 3)
        self.stage.verts = coords
        self.stage.vrefs = (
            np.zeros(len(coords), np.int32) if refs is None
            else np.asarray(refs, np.int32)
        )
        return ReturnStatus.SUCCESS

    def set_vertex(self, c0, c1, c2, ref: int, pos: int):
        if self.stage.verts is None:
            n = self._declared[0]
            self.stage.verts = np.zeros((n, 3), np.float64)
            self.stage.vrefs = np.zeros(n, np.int32)
        self.stage.verts[pos] = (c0, c1, c2)
        self.stage.vrefs[pos] = ref
        return ReturnStatus.SUCCESS

    def set_tetrahedra(self, tets, refs=None):
        tets = np.asarray(tets, np.int32).reshape(-1, 4)
        self.stage.tets = tets
        self.stage.trefs = (
            np.zeros(len(tets), np.int32) if refs is None
            else np.asarray(refs, np.int32)
        )
        return ReturnStatus.SUCCESS

    def set_tetrahedron(self, v0, v1, v2, v3, ref: int, pos: int):
        if self.stage.tets is None:
            n = self._declared[1]
            self.stage.tets = np.zeros((n, 4), np.int32)
            self.stage.trefs = np.zeros(n, np.int32)
        self.stage.tets[pos] = (v0, v1, v2, v3)
        self.stage.trefs[pos] = ref
        return ReturnStatus.SUCCESS

    def set_triangles(self, trias, refs=None):
        trias = np.asarray(trias, np.int32).reshape(-1, 3)
        self.stage.trias = trias
        self.stage.trrefs = (
            np.zeros(len(trias), np.int32) if refs is None
            else np.asarray(refs, np.int32)
        )
        return ReturnStatus.SUCCESS

    def set_triangle(self, v0, v1, v2, ref: int, pos: int):
        if self.stage.trias is None:
            n = self._declared[2]
            self.stage.trias = np.zeros((n, 3), np.int32)
            self.stage.trrefs = np.zeros(n, np.int32)
        self.stage.trias[pos] = (v0, v1, v2)
        self.stage.trrefs[pos] = ref
        return ReturnStatus.SUCCESS

    def set_edges(self, edges, refs=None):
        edges = np.asarray(edges, np.int32).reshape(-1, 2)
        self.stage.edges = edges
        self.stage.edrefs = (
            np.zeros(len(edges), np.int32) if refs is None
            else np.asarray(refs, np.int32)
        )
        return ReturnStatus.SUCCESS

    def set_corner(self, pos: int):
        self.stage.corners.append(pos)
        return ReturnStatus.SUCCESS

    def set_required_vertex(self, pos: int):
        self.stage.req_verts.append(pos)
        return ReturnStatus.SUCCESS

    def set_required_triangle(self, pos: int):
        self.stage.req_trias.append(pos)
        return ReturnStatus.SUCCESS

    def set_required_edge(self, pos: int):
        self.stage.req_edges.append(pos)
        return ReturnStatus.SUCCESS

    def set_ridge(self, pos: int):
        self.stage.ridges.append(pos)
        return ReturnStatus.SUCCESS

    # --- solutions --------------------------------------------------------
    def set_met_size(self, typ: str, np_: int):
        ncomp = _SOL_SIZES[typ]
        self.stage.met = np.ones((np_, ncomp), np.float64)
        return ReturnStatus.SUCCESS

    def set_metric_sols(self, values):
        values = np.asarray(values, np.float64)
        if values.ndim == 1:
            values = values[:, None]
        if values.shape[1] not in (1, 6):
            raise ValueError("metric must be scalar or symmetric tensor")
        self.stage.met = values
        return ReturnStatus.SUCCESS

    def set_scalar_met(self, value: float, pos: int):
        self.stage.met[pos, 0] = value
        return ReturnStatus.SUCCESS

    def set_tensor_met(self, six, pos: int):
        self.stage.met[pos, :] = six
        return ReturnStatus.SUCCESS

    def set_level_set(self, values):
        self.stage.ls = np.asarray(values, np.float64).reshape(-1, 1)
        return ReturnStatus.SUCCESS

    def set_displacement(self, values):
        self.stage.disp = np.asarray(values, np.float64).reshape(-1, 3)
        return ReturnStatus.SUCCESS

    def set_field(self, values):
        v = np.asarray(values, np.float64)
        self.stage.fields.append(v.reshape(len(v), -1))
        return ReturnStatus.SUCCESS

    # --- parameters (PMMG_Set_iparameter / _dparameter) -------------------
    def set_iparameter(self, param: Param, value: int):
        param = Param(param)
        o = self.opts
        if param == Param.IPARAM_verbose:
            o.verbose = int(value)
        elif param == Param.IPARAM_niter:
            o.niter = int(value)
        elif param == Param.IPARAM_noinsert:
            o.noinsert = bool(value)
        elif param == Param.IPARAM_noswap:
            o.noswap = bool(value)
        elif param == Param.IPARAM_nomove:
            o.nomove = bool(value)
        elif param == Param.IPARAM_nosurf:
            o.nosurf = bool(value)
        elif param == Param.IPARAM_optim:
            o.optim = bool(value) or o.optim_les
        elif param == Param.IPARAM_optimLES:
            o.optim_les = bool(value)
            # optimLES implies optim, which unlatches when optimLES is
            # cleared unless IPARAM_optim was set on its own
            o.optim = o.optim_les or bool(
                self.iparam.get(Param.IPARAM_optim, 0)
            )
        elif param == Param.IPARAM_nofem:
            o.nofem = bool(value)
        elif param == Param.IPARAM_anisosize:
            o.aniso = bool(value)
        elif param == Param.IPARAM_angle:
            if not value:
                o.angle = None
            elif o.angle is None:
                # re-enabled: the last DPARAM value or the 45-degree
                # default (the reference's toggle semantics)
                from .ops.analysis import ANG_DEFAULT

                last = self.dparam.get(Param.DPARAM_angleDetection)
                o.angle = ANG_DEFAULT if last is None else last
        elif param == Param.IPARAM_nobalancing:
            o.nobalancing = bool(value)
        elif param == Param.IPARAM_ifcLayers:
            o.ifc_layers = int(value)
        elif param == Param.IPARAM_groupsRatio:
            o.grps_ratio = float(value)
        elif param == Param.IPARAM_nparts:
            o.nparts = int(value)
        elif param == Param.IPARAM_APImode:
            self.api_mode = APIDistrib(value)
        elif param == Param.IPARAM_mem:
            # memory budget in MB per shard
            o.mem_budget_mb = float(value) if value > 0 else None
        elif param == Param.IPARAM_opnbdy:
            o.opnbdy = bool(value)
        elif param == Param.IPARAM_lag:
            if value >= 0:
                raise ValueError(
                    "lagrangian motion (IPARAM_lag) is not implemented"
                )
        elif param == Param.IPARAM_debug:
            # debug mode checks the communicators each iteration
            o.check_comm = bool(value)
        elif param == Param.IPARAM_meshSize:
            # the pre-split growth floor per shard
            if value > 0:
                o.min_shard_elts = int(value)
        elif param in (Param.IPARAM_octree, Param.IPARAM_metisRatio):
            import warnings

            warnings.warn(
                f"{param.name} has no effect in this runtime (obviated: "
                "batched kernels use no octree; partitioning is "
                "SFC-based, not Metis)", stacklevel=2,
            )
        # every other parameter (IPARAM_globalNum: the numbering getters
        # always work) is kept for get_iparameter only
        self.iparam[param] = int(value)
        return ReturnStatus.SUCCESS

    def get_iparameter(self, param: Param) -> int:
        return self.iparam.get(Param(param), 0)

    def set_dparameter(self, param: Param, value: float):
        param = Param(param)
        o = self.opts
        if param == Param.DPARAM_hmin:
            o.hmin = float(value)
        elif param == Param.DPARAM_hmax:
            o.hmax = float(value)
        elif param == Param.DPARAM_hsiz:
            o.hsiz = float(value)
        elif param == Param.DPARAM_hausd:
            o.hausd = float(value)
        elif param == Param.DPARAM_hgrad:
            o.hgrad = None if value <= 0 else float(value)
        elif param == Param.DPARAM_hgradreq:
            o.hgradreq = None if value <= 0 else float(value)
        elif param == Param.DPARAM_angleDetection:
            o.angle = float(value)
        elif param == Param.DPARAM_balanceBand:
            o.balance_band = float(value)
        self.dparam[param] = float(value)
        return ReturnStatus.SUCCESS

    def get_dparameter(self, param: Param) -> float:
        return self.dparam.get(Param(param), 0.0)

    def set_checkpoint(self, dirpath: Optional[str] = None, *,
                       store=None, every: int = 1, keep: int = 2,
                       async_staging: bool = False):
        """Checkpoint and resume of the next run: not ported yet."""
        raise NotImplementedError(
            "ParMesh.set_checkpoint is not ported yet: ROADMAP queue 1, "
            "item 15 (failsafe/checkpoint) brings it")

    # --- distributed-API communicator setters -----------------------------
    def set_number_of_node_communicators(self, n: int):
        self._node_comms = [None] * n
        self.api_mode = APIDistrib.NODES
        return ReturnStatus.SUCCESS

    def set_number_of_face_communicators(self, n: int):
        self._face_comms = [None] * n
        self.api_mode = APIDistrib.FACES
        return ReturnStatus.SUCCESS

    def set_ith_node_communicator_size(self, i: int, color: int, size: int):
        self._node_comms[i] = (
            color, np.zeros(size, np.int64), np.zeros(size, np.int64)
        )
        return ReturnStatus.SUCCESS

    def set_ith_node_communicator_nodes(self, i: int, local_ids,
                                        global_ids=None):
        color, loc, glob = self._node_comms[i]
        loc[:] = np.asarray(local_ids)
        if global_ids is not None:
            glob[:] = np.asarray(global_ids)
        return ReturnStatus.SUCCESS

    def set_ith_face_communicator_size(self, i: int, color: int, size: int):
        self._face_comms[i] = (
            color, np.zeros(size, np.int64), np.zeros(size, np.int64)
        )
        return ReturnStatus.SUCCESS

    def set_ith_face_communicator_faces(self, i: int, local_ids,
                                        global_ids=None):
        color, loc, glob = self._face_comms[i]
        loc[:] = np.asarray(local_ids)
        if global_ids is not None:
            glob[:] = np.asarray(global_ids)
        return ReturnStatus.SUCCESS

    def get_ith_node_communicator_nodes(self, i: int):
        return self._node_comms[i]

    # --- build + run ------------------------------------------------------
    def _build_mesh(self) -> Mesh:
        s = self.stage
        if s.verts is None or s.tets is None:
            raise ValueError("vertices and tetrahedra must be set")
        vtags = np.zeros(len(s.verts), np.int32)
        vtags[np.asarray(s.corners, int)] |= tags.CORNER | tags.REQUIRED
        vtags[np.asarray(s.req_verts, int)] |= tags.REQUIRED
        trtags = None
        if s.trias is not None:
            trtags = np.zeros(len(s.trias), np.int32)
            trtags[np.asarray(s.req_trias, int)] |= tags.REQUIRED
        edtags = None
        if s.edges is not None:
            edtags = np.zeros(len(s.edges), np.int32)
            edtags[np.asarray(s.req_edges, int)] |= tags.REQUIRED
            edtags[np.asarray(s.ridges, int)] |= tags.RIDGE
        fields = None
        ncomp: Tuple[int, ...] = ()
        if s.fields:
            fields = np.concatenate(s.fields, axis=1)
            ncomp = tuple(f.shape[1] for f in s.fields)
        return Mesh.from_numpy(
            s.verts, s.tets, vrefs=s.vrefs, trefs=s.trefs,
            trias=s.trias, trrefs=s.trrefs,
            edges=s.edges, edrefs=s.edrefs,
            vtags=vtags, trtags=trtags, edtags=edtags,
            met=s.met, ls=s.ls, disp=s.disp,
            fields=fields, field_ncomp=ncomp, device=self.device,
        )

    def load_mesh(self, path: str, metpath: str | None = None):
        """`PMMG_loadMesh_centralized`: a Medit mesh (and metric) read
        onto the ParMesh's device; `parmmglib_centralized` adapts it in
        place of the staged arrays."""
        from .io import medit

        m = medit.load_mesh(path, metpath, device=self.device)
        self.mesh = m
        self._loaded = m
        return ReturnStatus.SUCCESS

    def parmmglib_centralized(self) -> ReturnStatus:
        """`PMMG_parmmglib_centralized` (reference `src/libparmmg.c:1444`):
        adapt the loaded or staged mesh, on one shard or, with nparts >
        1, on `nparts` shards merged at the end. A failure is graded:
        LOWFAILURE while a result mesh stands (after `load_mesh`, the
        input), STRONGFAILURE otherwise."""
        from .models.adapt import adapt
        from .models.distributed import adapt_distributed, merge_adapted

        mesh = getattr(self, "_loaded", None)
        if mesh is None:
            mesh = self._build_mesh()
        try:
            if self.opts.nparts <= 1:
                aopts = AdaptOptions(**{
                    f.name: getattr(self.opts, f.name)
                    for f in dataclasses.fields(AdaptOptions)
                })
                self.mesh, self.info = adapt(mesh, aopts,
                                             device=self.device)
            else:
                self.stacked, self.comm, self.info = adapt_distributed(
                    mesh, self.opts, device=self.device
                )
                self.mesh = merge_adapted(self.stacked, self.comm)
            self.status = ReturnStatus(
                self.info.get("status", ReturnStatus.SUCCESS)
            )
        except Exception as e:  # graded failure: keep the last valid mesh
            from . import failsafe

            self.info = dict(error=str(e), error_type=type(e).__name__)
            self.status = failsafe.classify(e, self.mesh is not None)
        return self.status

    def parmmglib_distributed(self) -> ReturnStatus:
        """`PMMG_parmmglib_distributed` (reference `src/libparmmg.c:1519`):
        adapt a mesh given per shard with its node tables (`self.stacked`
        and `self.comm`, as `io.medit.load_mesh_distributed` returns
        them)."""
        from .models.distributed import adapt_stacked_input

        if self.stacked is None:
            raise ValueError(
                "distributed input requires a stacked mesh (use "
                "io.medit distributed load or stage shards)"
            )
        try:
            self.stacked, self.comm, self.info = adapt_stacked_input(
                self.stacked, self.comm, self.opts, device=self.device
            )
            self.status = ReturnStatus(
                self.info.get("status", ReturnStatus.SUCCESS)
            )
        except Exception as e:
            self.info = dict(error=str(e), error_type=type(e).__name__)
            self.status = ReturnStatus.STRONGFAILURE
        return self.status

    # --- getters ----------------------------------------------------------
    def _result_mesh(self) -> Mesh:
        if self.mesh is None:
            raise ValueError("no result mesh; run parmmglib_* first")
        return self.mesh

    def get_vertices(self):
        d = self._result_mesh().to_numpy()
        return d["verts"], d["vrefs"]

    def get_tetrahedra(self):
        d = self._result_mesh().to_numpy()
        return d["tets"], d["trefs"]

    def get_triangles(self):
        d = self._result_mesh().to_numpy()
        return d["trias"], d["trrefs"]

    def get_edges(self):
        d = self._result_mesh().to_numpy()
        return d["edges"], d["edrefs"]

    def get_metric_sols(self):
        return self._result_mesh().to_numpy()["met"]

    def get_vertex_glonum(self):
        """Global vertex numbering of the result
        (`PMMG_Compute_verticesGloNum` role). Distributed result: a list
        of per-shard [np] arrays (interface vertices share one id);
        centralized: one contiguous 0..np-1 array."""
        if self.stacked is not None:
            vglob = self.stacked.vglob.cpu().numpy()
            vmask = self.stacked.vmask.cpu().numpy()
            return [vglob[s][vmask[s]] for s in range(vglob.shape[0])]
        d = self._result_mesh().to_numpy()
        return np.arange(len(d["verts"]), dtype=np.int64)

    def get_triangle_glonum(self):
        """Global triangle numbering of the result
        (`PMMG_Compute_trianglesGloNum` role). Distributed result: a list
        of per-shard [nt] arrays over the live trias (synthetic interface
        trias read -1, replicated boundary trias share one id);
        centralized: 0..nt-1."""
        if self.stacked is None:
            d = self._result_mesh().to_numpy()
            return np.arange(len(d["trias"]), dtype=np.int64)
        from .parallel.distribute import assign_triangle_gids

        gids = assign_triangle_gids(self.stacked)
        trmask = self.stacked.trmask.cpu().numpy()
        return [gids[s][trmask[s]] for s in range(gids.shape[0])]

    def get_node_communicator_owners(self):
        """Per shard: (owner_rank [n], global_id [n], nunique, ntot) over
        that shard's interface vertices (the
        `PMMG_Get_NodeCommunicator_owners` role). The owner is the lowest
        shard sharing the vertex; nunique counts each interface vertex
        once, ntot counts replicas."""
        if self.comm is None:
            raise ValueError("no distributed result; run with nparts > 1")
        l2g = self.comm.l2g.cpu().numpy()
        owner = self.comm.owner.cpu().numpy()
        D = l2g.shape[0]
        live = l2g >= 0
        # interface = a global id held by more than one shard
        gmax = int(l2g.max(initial=0)) + 1
        mult = np.zeros(gmax, np.int64)
        owner_rank = np.full(gmax, 2**30, np.int64)
        for s in range(D):
            g = l2g[s][live[s]]
            np.add.at(mult, g, 1)
            np.minimum.at(owner_rank, g, s)
        ifc = live & (mult[np.maximum(l2g, 0)] > 1)
        ntot = int(ifc.sum())
        nunique = int(owner[ifc].sum())
        return [
            (owner_rank[l2g[s][ifc[s]]], l2g[s][ifc[s]], nunique, ntot)
            for s in range(D)
        ]

    def save_mesh(self, path: str):
        from .io import medit

        medit.save_mesh(self._result_mesh(), path)
        return ReturnStatus.SUCCESS

    def save_met(self, path: str):
        from .io import medit

        medit.save_met(self._result_mesh(), path)
        return ReturnStatus.SUCCESS


def adapt_file(inmesh: str, insol: str, outmesh: str, hsiz: float,
               niter: int, nparts: int, device=None) -> int:
    """File-driven one-call adaptation, the target of the C ABI's
    `pmmgtpu_adapt_file`: load -> adapt (on one shard, or on `nparts`
    merged at the end) -> save on `device` (default: the GPU), returning
    the graded ReturnStatus as an int. `insol` may be "" (no metric
    file); `hsiz` <= 0 means "use the sol metric"."""
    from .io import medit
    from .models.adapt import adapt as _adapt

    try:
        dev = resolve_device(device)
        mesh = medit.load_mesh(inmesh, insol or None, device=dev)
        hs = hsiz if hsiz > 0 else None
        if nparts > 1:
            from .models.distributed import adapt_distributed, merge_adapted

            st, comm, info = adapt_distributed(
                mesh, DistOptions(hsiz=hs, niter=niter, nparts=nparts),
                device=dev)
            out = merge_adapted(st, comm)
            status = int(info["status"])
        else:
            out, info = _adapt(mesh, AdaptOptions(hsiz=hs, niter=niter),
                               device=dev)
            status = int(info.get("status", ReturnStatus.SUCCESS))
        medit.save_mesh(out, outmesh)
        return status
    except Exception:
        import traceback

        traceback.print_exc()
        return int(ReturnStatus.STRONGFAILURE)
