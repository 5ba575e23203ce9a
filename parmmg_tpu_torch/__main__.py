"""CLI: `python -m parmmg_tpu_torch input.mesh [-sol met.sol] [options]
[-out out.mesh]`.

Counterpart of `parmmg_tpu/__main__.py`, with the same flag names: load
→ adapt on the GPU → save, printing the reference-style quality and
edge-length histograms. Sweeps are active-set (frontier) sweeps unless
`-nofrontier` is given. `-nparts N` adapts on N stacked shards,
rebalancing between iterations (interface displacement, `-nlayers`; the
graph cut on the last iteration; a full re-cut past `-groups-ratio` or
the `-balance` band); `-nobalance` keeps the interfaces where the
partition put them. `-field f.sol` carries solution fields through the
adaptation and writes them as `<out>.fields.sol`; `-ls [iso]` splits the
mesh along the level set given by `-sol` before adapting; a `.vtu` name
reads or writes ASCII VTK; `.meshb`/`.solb` names read or write binary
Medit. `-rn` renumbers the tets along the Morton curve first.
`-pure-partitioning` writes the per-rank files `<out>.<r>.mesh` (and
their metrics) of the Morton partition and stops; `-distributed-input`
reads such files `<input>.<r>.mesh` (metric `<sol>.<r>.sol`) and writes
per-rank output unless `-centralized-output` is given;
`-distributed-output` writes per-rank files (or a `.pvtu`) after any
input. The checkpoint flags are accepted by the parser and refused with
`NotImplementedError` naming the ROADMAP item that brings them.

Started as N processes under the env contract of `parallel/multihost.py`
(as `mpirun -np N parmmg` starts the reference), the processes run as
one world: every rank runs the CLI on the same arguments, replicates the
host phases, sweeps the `-nparts` shards it owns (a contiguous block)
on its own card and joins the others' with one gather a sweep, and
writes what it is told to write; the result is that of one process bit
for bit. At `-v 1` each rank prints its gathers and kernel launches as
one JSON line, `## rank r of N: {...}`.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m parmmg_tpu_torch",
        description="GPU parallel tetrahedral remesher (PyTorch/CUDA port "
        "of parmmg_tpu)",
    )
    p.add_argument("input", nargs="?", default=None,
                   help="input .mesh/.meshb (Medit) or .vtu")
    p.add_argument("-out", "-o", dest="out", default=None,
                   help="output mesh name (default <input>.o.mesh)")
    p.add_argument("-sol", "-met", dest="sol", default=None,
                   help="metric .sol file")
    p.add_argument("-field", dest="field", default=None,
                   help="solution-field .sol to interpolate from the "
                   "input onto the adapted mesh")
    p.add_argument("-noout", action="store_true",
                   help="do not write the output mesh")
    p.add_argument("-val", dest="print_val", action="store_true",
                   help="print the default parameter values and exit")
    p.add_argument("-v", dest="verbose", type=int, default=1,
                   help="verbosity level")
    p.add_argument("-m", dest="mem", type=float, default=None,
                   help="memory budget in MB for the mesh tensors")
    p.add_argument("-hsiz", type=float, default=None,
                   help="constant target edge size")
    p.add_argument("-hmin", type=float, default=None)
    p.add_argument("-hmax", type=float, default=None)
    p.add_argument("-hgrad", type=float, default=None,
                   help="size gradation ratio (<=0 disables)")
    p.add_argument("-hausd", type=float, default=None,
                   help="Hausdorff bound for boundary approximation")
    p.add_argument("-ar", dest="angle", type=float, default=45.0,
                   help="ridge-detection dihedral angle (degrees)")
    p.add_argument("-nr", dest="no_angle", action="store_true",
                   help="disable angle detection")
    p.add_argument("-hgradreq", type=float, default=None,
                   help="gradation ratio propagated from required "
                   "entities (<=0 disables)")
    p.add_argument("-optim", action="store_true",
                   help="keep mesh-implied sizes, only improve quality")
    p.add_argument("-optimLES", dest="optim_les", action="store_true",
                   help="strong mesh optimization for LES (iso only)")
    p.add_argument("-A", dest="aniso", action="store_true",
                   help="enable anisotropy (without metric file)")
    p.add_argument("-nofem", action="store_true",
                   help="accepted for parity (no non-FE configurations "
                   "are ever created)")
    p.add_argument("-rn", dest="renumber", action="store_true",
                   help="Morton-order renumbering of the tets for "
                   "locality")
    p.add_argument("-noinsert", action="store_true")
    p.add_argument("-noswap", action="store_true")
    p.add_argument("-nomove", action="store_true")
    p.add_argument("-nofrontier", dest="nofrontier", action="store_true",
                   help="disable active-set (frontier) sweeps: full-table "
                   "sweeps")
    p.add_argument("-nosurf", action="store_true",
                   help="freeze the boundary surface exactly")
    p.add_argument("-opnbdy", action="store_true",
                   help="preserve open internal boundaries")
    p.add_argument("-niter", type=int, default=3,
                   help="outer remesh iterations")
    p.add_argument("-nparts", type=int, default=1,
                   help="number of shards; under a world of ranks each "
                   "rank sweeps a contiguous block of them")
    p.add_argument("-nobalance", dest="nobalancing", action="store_true",
                   help="no resharding between iterations (frozen "
                   "interfaces)")
    p.add_argument("-balance", dest="balance_band", type=float,
                   default=None,
                   help="closed-loop balance band: measured work "
                   "imbalance (max/mean) above this forces a full re-cut, "
                   "with hysteresis (default 1.5, env "
                   "PMMGTPU_BALANCE_BAND; <= 0 disables)")
    p.add_argument("-nlayers", dest="ifc_layers", type=int, default=2,
                   help="interface-displacement advancing-front depth")
    p.add_argument("-groups-ratio", dest="grps_ratio", type=float,
                   default=2.0, help="max shard imbalance before SFC recut")
    p.add_argument("-mesh-size", dest="mesh_size", type=int, default=None,
                   help="minimum elements per shard before the run is "
                   "distributed (smaller meshes grow on one shard first)")
    p.add_argument("-pure-partitioning", action="store_true",
                   help="partition and save the per-rank files only, "
                   "no remeshing")
    p.add_argument("-distributed-output", dest="dist_out",
                   action="store_true",
                   help="save per-rank name.<rank>.mesh files (or a "
                   ".pvtu)")
    p.add_argument("-centralized-output", dest="cent_out",
                   action="store_true",
                   help="save one merged mesh (the default after "
                   "centralized input)")
    p.add_argument("-distributed-input", dest="dist_in",
                   action="store_true",
                   help="input is per-rank name.<rank>.mesh files")
    p.add_argument("-ls", type=float, nargs="?", const=0.0, default=None,
                   help="level-set discretization at the given isovalue "
                   "(the -sol file is the level set)")
    p.add_argument("-ckpt", dest="ckpt", default=None)
    p.add_argument("-ckpt-every", dest="ckpt_every", type=int, default=None)
    p.add_argument("-ckpt-async", dest="ckpt_async", action="store_true")
    return p


# flags of paths not in this slice: (flag, dest, "is set" test, ROADMAP
# item that brings it)
_REFUSED = (
    ("-ckpt", "ckpt", lambda v: v is not None,
     "queue 1, item 15 (checkpoint/resume)"),
    ("-ckpt-every", "ckpt_every", lambda v: v is not None,
     "queue 1, item 15 (checkpoint/resume)"),
    ("-ckpt-async", "ckpt_async", bool,
     "queue 1, item 15 (checkpoint/resume)"),
)


def _refuse_unported(args) -> None:
    for flag, dest, is_set, item in _REFUSED:
        if is_set(getattr(args, dest)):
            raise NotImplementedError(
                f"{flag}: not ported yet — ROADMAP {item} brings it")


def print_default_values() -> None:
    """`-val`: print the default parameters."""
    from .models.distributed import DistOptions
    from .parallel.migrate import BALANCE_BAND_DEFAULT

    d = DistOptions()
    print("\nDefault parameters values:")
    print("\n** Generic options")
    print("verbosity (-v)          : 1")
    print("\n** Parameters")
    print(f"niter (-niter)          : {d.niter}")
    print("nparts (-nparts)        : 1")
    print(f"ifc layers (-nlayers)   : {d.ifc_layers}")
    print(f"groups ratio            : {d.grps_ratio}")
    band = d.balance_band or BALANCE_BAND_DEFAULT
    print(f"balance band (-balance) : {band}")
    print(f"angle detection (-ar)   : {d.angle}")
    print(f"hgrad (-hgrad)          : {d.hgrad}")
    print(f"hgradreq (-hgradreq)    : {d.hgradreq or 'off'}")
    print("hausd (-hausd)          : 0.01 x bounding-box diagonal")
    print("hmin / hmax             : off")
    print(f"max sweeps per iter     : {d.max_sweeps}")
    print("memory budget (-m)      : 90% of the device memory")


def main(argv=None, device=None) -> int:
    """Run the CLI on `device` (default: the GPU — raises when there is
    none). Returns the exit code."""
    args = build_parser().parse_args(argv)
    if args.print_val:
        print_default_values()
        return 0
    if args.input is None:
        build_parser().error("an input mesh is required")
    if args.field and args.dist_in:
        # the reference prints the same error (`src/parmmg.c:300`)
        print("  ## Error: Distributed fields input not yet "
              "implemented.", file=sys.stderr)
        return 1
    _refuse_unported(args)

    import torch

    from . import resolve_device
    from .io import medit, parsop, vtk
    from .models.adapt import adapt
    from .models.distributed import (DistOptions, adapt_distributed,
                                     adapt_stacked_input)
    from .ops import quality
    from .utils.timing import Timers

    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    timers = Timers(enabled=args.verbose >= 1, sync=sync)
    out = args.out or (os.path.splitext(args.input)[0] + ".o.mesh")
    angle = None if args.no_angle else args.angle
    hgrad = (
        None if (args.hgrad is not None and args.hgrad <= 0)
        else (args.hgrad if args.hgrad is not None else 1.3)
    )
    hgradreq = (
        None if (args.hgradreq is None or args.hgradreq <= 0)
        else args.hgradreq
    )

    local_params = ()
    pf = parsop.default_param_file(args.input)
    if pf is not None:
        local_params = parsop.parse_local_params(pf)
        if args.verbose >= 1:
            print(f"  %% {pf}: {len(local_params)} local parameter(s)")

    opts = DistOptions(
        niter=args.niter,
        hsiz=args.hsiz, hmin=args.hmin, hmax=args.hmax,
        hgrad=hgrad, hgradreq=hgradreq, hausd=args.hausd, angle=angle,
        optim=args.optim or args.optim_les, optim_les=args.optim_les,
        aniso=args.aniso, nofem=args.nofem, local_params=local_params,
        noinsert=args.noinsert, noswap=args.noswap, nomove=args.nomove,
        nosurf=args.nosurf, opnbdy=args.opnbdy, verbose=args.verbose,
        mem_budget_mb=args.mem, frontier=not args.nofrontier,
        nparts=args.nparts, nobalancing=args.nobalancing,
        balance_band=args.balance_band, ifc_layers=args.ifc_layers,
        grps_ratio=args.grps_ratio,
        min_shard_elts=args.mesh_size or DistOptions.min_shard_elts,
    )

    fields = None
    if args.field:
        fields, field_ncomp = medit.load_fields(args.field)

    mesh = None
    with timers.phase("input"):
        if args.dist_in:
            stacked, comm = medit.load_mesh_distributed(
                args.input, args.nparts, metpath=args.sol, device=device)
        elif args.ls is not None:
            # in ls mode the sol file is the level set
            raw = medit.read_mesh(args.input)
            ls = None
            if args.sol:
                ls = medit.read_sol(args.sol)[0][:, :1]
            mesh = medit.raw_to_mesh(raw, ls=ls, device=device)
        elif args.input.endswith(".vtu"):
            mesh = vtk.load_vtu(args.input, device=device)
        else:
            mesh = medit.load_mesh(args.input, args.sol, device=device)
        if fields is not None:
            npo = int(mesh.npoin)
            if len(fields) != npo:
                print(f"  ## Error: -field has {len(fields)} entries "
                      f"for {npo} vertices.", file=sys.stderr)
                return 1
            pad = torch.zeros((mesh.pcap, fields.shape[1]),
                              dtype=mesh.dtype)
            pad[:npo] = torch.from_numpy(fields)
            mesh = mesh.replace(fields=pad.to(device),
                                field_ncomp=tuple(field_ncomp))

    if (args.ls is not None or args.pure_partitioning) and mesh is None:
        print(f"{'-ls' if args.ls is not None else '-pure-partitioning'} "
              "requires centralized input", file=sys.stderr)
        return 1
    if args.ls is not None:
        from .models.levelset import discretize_levelset

        with timers.phase("level-set"):
            mesh = discretize_levelset(mesh, isovalue=args.ls)

    if args.renumber and mesh is not None:
        from .core.adjacency import build_adjacency
        from .parallel.partition import renumber_sfc

        with timers.phase("renumbering"):
            mesh = build_adjacency(renumber_sfc(mesh))

    if args.pure_partitioning:
        from .parallel.distribute import split_mesh
        from .parallel.partition import sfc_partition

        with timers.phase("partitioning"):
            part = sfc_partition(mesh, args.nparts).cpu().numpy()
            stacked, comm = split_mesh(mesh, part, args.nparts)
        with timers.phase("output"):
            medit.save_mesh_distributed(stacked, comm, out,
                                        with_met=mesh.met_set)
        timers.report()
        return 0

    mesh_out = None
    with timers.phase("remeshing"):
        if args.dist_in:
            stacked, comm, info = adapt_stacked_input(stacked, comm, opts,
                                                      device=device)
        elif args.nparts > 1:
            stacked, comm, info = adapt_distributed(mesh, opts,
                                                    device=device)
        else:
            # DistOptions extends AdaptOptions: the single-shard driver
            # ignores the distribution fields
            mesh_out, info = adapt(mesh, opts, device=device)

    if args.verbose >= 1:
        for rec in info["history"]:
            if "failure" in rec:
                print(f"  ## iteration {rec['iter']} rolled back "
                      f"({rec['error']}): {rec['failure']}")
        for b in info.get("balance", ()):
            print(f"  ## iteration {b['it']} rebalanced ({b['trigger']}): "
                  f"{b['cells']} cells moved, imbalance "
                  f"{b['imbalance_pre']} -> {b['imbalance_post']}, "
                  f"{b['wall_s']} s")
        print(quality.format_histogram(info["qual_in"],
                                       "INPUT MESH QUALITY"))
        print(quality.format_histogram(info["qual_out"],
                                       "OUTPUT MESH QUALITY"))
        print(quality.format_length_stats(info["len_out"]))

    if not args.noout:
        with timers.phase("output"):
            _save_output(args, out, mesh_out,
                         None if mesh_out is not None else (stacked, comm))
    if args.verbose >= 1:
        _report_rank()
    timers.report()
    return 0


def _report_rank() -> None:
    """Under a world of ranks, this rank's gathers (calls, bytes, wall
    seconds) and kernel launches as one JSON line."""
    import json

    from . import kernels
    from .parallel import multihost

    if not multihost.is_multiprocess():
        return
    r, w = multihost.rank(), multihost.world_size()
    g = multihost.GATHERS
    print(f"## rank {r} of {w}: " + json.dumps(dict(
        rank=r, world=w, gathers=g["n"], gather_bytes=g["bytes"],
        gather_s=round(g["seconds"], 6), launches=dict(kernels.LAUNCHES))),
        flush=True)


def _save_output(args, out: str, mesh_out, dist) -> None:
    """The output block: per-rank files after distributed input or with
    `-distributed-output` (`-centralized-output` overrides), else one
    merged mesh; `.vtu`/`.pvtu` names write VTK; `-field` writes the
    fields next to each mesh written. `dist` is (stacked, comm) of a
    distributed run, None after a centralized one."""
    from .io import medit, vtk
    from .models.distributed import merge_adapted
    from .parallel.distribute import stack_meshes, unstack_mesh

    distributed_out = not args.cent_out and (args.dist_out or args.dist_in)
    vtu = out.endswith((".vtu", ".pvtu"))
    if distributed_out and dist is not None:
        if vtu:
            vtk.save_pvtu(*dist, out)
        else:
            medit.save_mesh_distributed(*dist, out, with_met=True)
    elif distributed_out:
        # a single-part run asked for distributed output: one rank file
        one = medit.shard_filename(out, 0)
        if out.endswith(".pvtu"):
            # a .pvtu indexes .vtu pieces: the piece and its index
            vtk.save_pvtu(stack_meshes([mesh_out]), None, out)
        elif vtu:
            vtk.save_vtu(mesh_out, one)
        else:
            medit.save_mesh(mesh_out, one)
            medit.save_met(mesh_out, medit.met_filename(one))
    else:
        if mesh_out is None:
            mesh_out = merge_adapted(*dist)
        # a .pvtu name without distributed output gets the .vtu content,
        # as in the JAX package
        if vtu:
            vtk.save_vtu(mesh_out, out)
        else:
            medit.save_mesh(mesh_out, out)
            medit.save_met(mesh_out, medit.met_filename(out))
    if not args.field or vtu:
        return
    if distributed_out and dist is not None:
        # per-rank fields next to the per-rank meshes, in their numbering
        for r, shard in enumerate(unstack_mesh(dist[0])):
            medit.save_fields(shard, os.path.splitext(
                medit.shard_filename(out, r))[0] + ".fields.sol")
    else:
        if mesh_out is None:
            mesh_out = merge_adapted(*dist)
        medit.save_fields(mesh_out, os.path.splitext(out)[0] + ".fields.sol")


if __name__ == "__main__":
    sys.exit(main())
