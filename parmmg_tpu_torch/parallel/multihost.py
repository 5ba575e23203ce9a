"""Multi-process runtime: the ranks of one run on `torch.distributed`.

Counterpart of `parmmg_tpu/parallel/multihost.py`. The reference scales
across nodes with its MPI world (`mpirun -np N parmmg`); the JAX package
with JAX's multi-controller runtime; the port with a `torch.distributed`
process group. Every rank runs the same program on the same arguments:
the host phases (analysis, interpolation, balancing, convergence) are
replicated on the full stacked state, and only the sweeps split, each
rank sweeping the shards it owns (`shard.owned_shards`) and joining the
others' rows with one `gather_stacked` a sweep
(`models/distributed.remesh_phase`).

Env contract (mirrors `mpirun`'s rank/world interface, as in the JAX
package):
  PMMGTPU_COORDINATOR  host:port of rank 0's rendezvous (e.g.
                       "127.0.0.1:29500"); "auto" takes torchrun's
                       MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE
  PMMGTPU_NUM_PROCS    world size
  PMMGTPU_PROC_ID      this process's rank, 0-based

Single-process runs are unaffected: `init_from_env()` is a no-op unless
the coordinator variable is set. The collectives run on gloo with host
tensors: NCCL refuses two ranks on one GPU, and the state a collective
carries is copied to the host once a call (as the JAX package's
`gather_stacked` lands on host numpy). Each rank's device is
`cuda:(rank % device_count)`.

A collective that fails or times out raises `PeerLostError`, which the
iteration loops never roll back around: a rank that absorbed it would
leave its peers waiting in the next collective.
"""

from __future__ import annotations

import atexit
import os
import time

import torch


class MultihostConfigError(RuntimeError):
    """The PMMGTPU_* multi-process env contract is malformed
    (non-integer or out-of-range rank/world). Raised before the
    rendezvous, which would otherwise wait for a world that can never
    assemble (a rank >= world size means some expected rank never dials
    in)."""


class PeerLostError(RuntimeError):
    """A collective failed or timed out: a peer process died or hung, so
    the world is broken. Not recoverable in-process: the iteration loops
    re-raise it through the rollback (which cannot resurrect a peer)."""


_INITIALIZED = False
_DEVICE = None

# what the gathers of this process moved: calls, bytes of the gathered
# buffer (every rank's rows, padded to the largest owned count) and wall
# seconds, packing and unpacking included
GATHERS = {"n": 0, "bytes": 0, "seconds": 0.0}


def init_from_env() -> bool:
    """Join the world the env contract describes.

    Returns True when running multi-process (after joining), False for
    plain single-process runs. Idempotent. A malformed rank/world raises
    :class:`MultihostConfigError` up front instead of letting the
    rendezvous hang. Sets this rank's CUDA device where there is one."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coord = os.environ.get("PMMGTPU_COORDINATOR")
    if not coord:
        return False
    if coord == "auto":
        kw = dict(init_method="env://")
    else:
        nprocs = os.environ.get("PMMGTPU_NUM_PROCS")
        pid = os.environ.get("PMMGTPU_PROC_ID")
        if nprocs is None or pid is None:
            raise MultihostConfigError(
                "multi-host env contract incomplete: "
                f"PMMGTPU_COORDINATOR={coord!r} requires "
                "PMMGTPU_NUM_PROCS (world size) and PMMGTPU_PROC_ID "
                "(0-based rank) to be set as well"
            )
        try:
            world = int(nprocs)
            rank = int(pid)
        except ValueError as e:
            raise MultihostConfigError(
                f"PMMGTPU_NUM_PROCS={nprocs!r} / PMMGTPU_PROC_ID={pid!r} "
                "must be integers"
            ) from e
        if world <= 0:
            raise MultihostConfigError(
                f"PMMGTPU_NUM_PROCS={world} must be positive"
            )
        if not 0 <= rank < world:
            raise MultihostConfigError(
                f"PMMGTPU_PROC_ID={rank} out of range for "
                f"PMMGTPU_NUM_PROCS={world} (want 0 <= rank < world; "
                "the rendezvous would hang on this)"
            )
        kw = dict(init_method=f"tcp://{coord}", world_size=world, rank=rank)
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", **kw)
        atexit.register(_shutdown)
    _set_device(dist.get_rank())
    _INITIALIZED = True
    return True


def _set_device(rank: int) -> None:
    global _DEVICE
    if torch.cuda.is_available():
        _DEVICE = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(_DEVICE)


def _shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def local_device():
    """This rank's CUDA device under a world of ranks, else None."""
    return _DEVICE


def is_multiprocess() -> bool:
    return world_size() > 1


def world_size() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def rank() -> int:
    import torch.distributed as dist

    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def _collective(tag: str, fn):
    """Run the collective `fn`, any failure (gloo reports a timeout or a
    closed peer as a RuntimeError) raised as `PeerLostError`."""
    try:
        return fn()
    except PeerLostError:
        raise
    except Exception as e:
        raise PeerLostError(
            f"collective '{tag}' failed (rank {rank()}): {e}") from e


def barrier(tag: str = "parmmg-barrier") -> None:
    """Coordination barrier across all ranks (no-op single-process):
    returning from here means every peer reached this point (the
    `MPI_Barrier` role)."""
    if not is_multiprocess():
        return
    import torch.distributed as dist

    _collective(tag, dist.barrier)


def agree_flags(value: int, tag: str = "agree") -> int:
    """World-agreed bitwise OR of one small non-negative int per rank
    (the ``MPI_Allreduce(ier)`` role for control decisions every rank
    must take at the same boundary). Single-process this is the
    identity."""
    val = int(value)
    if not is_multiprocess():
        return val
    if val < 0:
        raise ValueError(f"agree_flags wants a non-negative int, got {val}")
    import torch.distributed as dist

    t = torch.tensor([val], dtype=torch.int64)
    _collective(tag, lambda: dist.all_reduce(t, op=dist.ReduceOp.BOR))
    return int(t.item())


# byte alignment of every tensor in a gathered row: the caching
# allocator's, so an unpacked view is aligned as a fresh tensor is
_ALIGN = 512


def _layout(row):
    """(offset, nbytes) of each tensor of `row` in its packed bytes, and
    the row's packed size."""
    spans, off = [], 0
    for t in row:
        n = t.numel() * t.element_size()
        spans.append((off, n))
        off += -(-n // _ALIGN) * _ALIGN
    return spans, off


def gather_stacked(rows, nshards: int, tag: str = "gather_stacked"):
    """The full list of `nshards` per-shard rows on every rank, from this
    rank's own rows: `rows` holds one tuple of tensors per shard this
    rank owns (`shard.owned_shards`, ascending), each tuple of the same
    shapes and dtypes on every shard. Single-process the rows are all
    the shards and come back as they are.

    Every rank's rows ride one collective a call: each tensor's bytes
    are packed into one buffer (on the tensors' device, then one copy to
    the host), padded to the largest owned count, all-gathered over
    gloo, and copied back to the device once, where each tensor of the
    other ranks' rows is a view of that buffer. This rank's own rows are
    returned as they were given."""
    if not is_multiprocess():
        return [tuple(r) for r in rows]
    from .shard import owned_shards

    rows = [tuple(r) for r in rows]
    if rows and rows[0][0].device.type == "cuda":
        # the time below is the gather's, not the sweep's still queued
        torch.cuda.synchronize(rows[0][0].device)
    t0 = time.perf_counter()
    world, me = world_size(), rank()
    owned = [owned_shards(nshards, r, world) for r in range(world)]
    if len(rows) != len(owned[me]) or not rows:
        raise ValueError(
            f"gather_stacked: rank {me} gave {len(rows)} rows for its "
            f"{len(owned[me])} shards of {nshards}")
    like = rows[0]
    spans, row_bytes = _layout(like)
    width = max(len(o) for o in owned)
    dev = like[0].device
    pads = {}

    def pad(n):
        if n not in pads:
            pads[n] = torch.zeros(n, dtype=torch.uint8, device=dev)
        return pads[n]

    parts = []
    for row in rows:
        for t, (_, n) in zip(row, spans):
            parts.append(t.contiguous().reshape(-1).view(torch.uint8))
            if -n % _ALIGN:
                parts.append(pad(-n % _ALIGN))
    if width > len(rows):
        parts.append(pad((width - len(rows)) * row_bytes))
    local = torch.cat(parts).cpu()
    import torch.distributed as dist

    slabs = [torch.empty_like(local) for _ in range(world)]
    _collective(tag, lambda: dist.all_gather(slabs, local))
    full = torch.cat([s[:len(o) * row_bytes]
                      for s, o in zip(slabs, owned)]).to(dev)
    out = []
    for i in range(nshards):
        r = next(r for r, o in enumerate(owned) if i in o)
        if r == me:
            out.append(rows[owned[me].index(i)])
            continue
        base = i * row_bytes
        out.append(tuple(
            full[base + o:base + o + n].view(t.dtype).reshape(t.shape)
            for t, (o, n) in zip(like, spans)))
    GATHERS["n"] += 1
    GATHERS["bytes"] += world * width * row_bytes
    GATHERS["seconds"] += time.perf_counter() - t0
    return out
