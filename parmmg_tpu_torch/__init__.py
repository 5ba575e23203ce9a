"""PyTorch / CUDA port of `parmmg_tpu`: batched tetrahedral remeshing on an
NVIDIA H100.

The package keeps the module layout of the JAX package (`core/`, `ops/`,
`kernels/`, `models/`, `io/`, `utils/`) so every function has a
counterpart under the same name. Meshes are dataclasses of tensors on one
explicit device; operators are plain functions on tensors. The four
Pallas kernels of the JAX package (`quality_vol`, `collapse_cavity`,
`split_midpoint`, `interp_bary`), which every adaptation path reaches,
are hand-written CUDA kernels here (`csrc/`, bound through `kernels/`),
each beside a plain PyTorch version of the same function.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no device given and no CUDA available they raise.

Started as N processes with the env contract of `parallel/multihost.py`
(`PMMGTPU_COORDINATOR`, `PMMGTPU_NUM_PROCS`, `PMMGTPU_PROC_ID`), the
package joins their `torch.distributed` world at import, and each rank
runs on `cuda:(rank % device_count)`.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]

# the JAX package's version this port follows, marked as the port's
__version__ = "0.3.0+torch"

# a run of several ranks (the mpirun -np analog): the world is joined
# before anything else runs, and only when the contract is set
import os as _os  # noqa: E402

if _os.environ.get("PMMGTPU_COORDINATOR"):
    from .parallel import multihost as _multihost  # noqa: E402

    _multihost.init_from_env()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the given one, else ``cuda``
    (this rank's card under a world of ranks).

    There is no silent CPU fallback: with no device given and no CUDA
    device present this raises, so a run that was meant for the GPU can
    never quietly take the plain PyTorch paths on the host."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "parmmg_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run on the host"
        )
    from .parallel import multihost

    dev = multihost.local_device()
    return dev if dev is not None else torch.device("cuda")
