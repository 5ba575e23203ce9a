"""Hand-written CUDA kernels of the port.

Counterpart of `parmmg_tpu/kernels/` (the Pallas kernels). Each kernel is
a CUDA C++ source under `csrc/`, compiled with `nvcc` for `sm_90a` into a
shared library with a plain C interface and bound with `ctypes`
(`build.py`), next to a plain PyTorch version of the same function:

- `quality_vol` — per-tet quality + signed volume (`quality_k.py`);
- `collapse_cavity` — gated quality of the retargeted collapse ball
  (`cavity_k.py`);
- `split_midpoint` — child-volume validity of split's offset midpoint
  (`cavity_k.py`);
- `interp_bary` — clamped barycentric weights of located points and the
  iso metric interpolated there (`interp_k.py`).

A wrapper launches its kernel for CUDA tensors (or raises: a failed build
or launch is a `KernelError`) and takes the plain version only for
tensors on the CPU. `LAUNCHES` counts the kernel
launches per name, `SHAPES` holds each one's last (rows, table rows
[, shards]).
"""

from .build import SOURCES as NAMES  # noqa: F401
from .build import (  # noqa: F401
    LAUNCHES,
    SHAPES,
    KernelError,
    build_all,
    reset_launches,
)
from .cavity_k import (  # noqa: F401
    collapse_cavity,
    collapse_cavity_plain,
    split_midpoint,
    split_midpoint_plain,
)
from .interp_k import interp_bary, interp_bary_plain  # noqa: F401
from .quality_k import quality_vol, quality_vol_plain  # noqa: F401
