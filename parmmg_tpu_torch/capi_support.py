"""Byte-buffer bridge for the C ABI (`native/parmmg_capi.c` of this
package).

Counterpart of `parmmg_tpu/capi_support.py`: the staged-arrays workflow
(set vertices / tets / trias / metric from raw buffers, adapt, read the
results back) crosses the FFI as contiguous bytes and is reshaped onto
`api.ParMesh` here. Entity indices cross the ABI 1-based, like the
reference API; the conversion to the 0-based arrays happens here.

`device` is the device the shim's handles and `pmmgtpu_adapt_file` run
on: None, the default, is the GPU. A Python program that loads the shim
into its own process may set it (the port's tests set "cpu").
"""

from __future__ import annotations

import numpy as np

from . import __version__
from .api import Param, ParMesh
from .api import adapt_file as _adapt_file

device = None


def make_parmesh(nparts: int) -> ParMesh:
    return ParMesh(nparts=max(1, int(nparts)), device=device)


def adapt_file(inmesh: str, insol: str, outmesh: str, hsiz: float,
               niter: int, nparts: int) -> int:
    return _adapt_file(inmesh, insol, outmesh, hsiz, niter, nparts,
                       device=device)


def version() -> str:
    return f"parmmg_tpu_torch {__version__}"


def set_vertices(pm: ParMesh, coords: bytes, refs: bytes | None, n: int):
    c = np.frombuffer(coords, np.float64).reshape(n, 3)
    r = np.frombuffer(refs, np.int32) if refs else None
    return int(pm.set_vertices(c, r))


def set_tetrahedra(pm: ParMesh, tets: bytes, refs: bytes | None, n: int):
    t = np.frombuffer(tets, np.int32).reshape(n, 4) - 1  # 1-based ABI
    r = np.frombuffer(refs, np.int32) if refs else None
    return int(pm.set_tetrahedra(t, r))


def set_triangles(pm: ParMesh, trias: bytes, refs: bytes | None, n: int):
    t = np.frombuffer(trias, np.int32).reshape(n, 3) - 1
    r = np.frombuffer(refs, np.int32) if refs else None
    return int(pm.set_triangles(t, r))


def set_metric(pm: ParMesh, met: bytes, n: int, ncomp: int):
    m = np.frombuffer(met, np.float64).reshape(n, ncomp)
    return int(pm.set_metric_sols(m))


def set_iparameter(pm: ParMesh, param: int, value: int):
    return int(pm.set_iparameter(Param(param), value))


def set_dparameter(pm: ParMesh, param: int, value: float):
    return int(pm.set_dparameter(Param(param), value))


def run(pm: ParMesh) -> int:
    return int(pm.parmmglib_centralized())


def get_mesh_size(pm: ParMesh):
    d = pm._result_mesh().to_numpy()
    return len(d["verts"]), len(d["tets"]), len(d["trias"])


def get_vertices(pm: ParMesh):
    d = pm._result_mesh().to_numpy()
    return (
        np.ascontiguousarray(d["verts"], np.float64).tobytes(),
        np.ascontiguousarray(d["vrefs"], np.int32).tobytes(),
    )


def get_tetrahedra(pm: ParMesh):
    d = pm._result_mesh().to_numpy()
    return (
        np.ascontiguousarray(d["tets"] + 1, np.int32).tobytes(),
        np.ascontiguousarray(d["trefs"], np.int32).tobytes(),
    )


def get_triangles(pm: ParMesh):
    d = pm._result_mesh().to_numpy()
    return (
        np.ascontiguousarray(d["trias"] + 1, np.int32).tobytes(),
        np.ascontiguousarray(d["trrefs"], np.int32).tobytes(),
    )


def get_metric(pm: ParMesh):
    d = pm._result_mesh().to_numpy()
    return np.ascontiguousarray(d["met"], np.float64).tobytes()
