"""CLI: `python -m parmmg_tpu_torch input.mesh [-sol met.sol] [options]
[-out out.mesh]`.

Counterpart of `parmmg_tpu/__main__.py` for centralized input and output,
with the same flag names: load → adapt on the GPU → save, printing the
reference-style quality and edge-length histograms. `-nparts N
-nobalance` adapts on N stacked shards with frozen interfaces and writes
the merged mesh. Flags of paths this slice of the port does not carry
(balancing between iterations, distributed I/O, fields, level-set, VTK,
checkpoints, renumbering, partitioning output) are accepted by the parser
and refused with `NotImplementedError` naming the ROADMAP item that
brings them.
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
                   help="input .mesh (Medit ASCII)")
    p.add_argument("-out", "-o", dest="out", default=None,
                   help="output mesh name (default <input>.o.mesh)")
    p.add_argument("-sol", "-met", dest="sol", default=None,
                   help="metric .sol file")
    p.add_argument("-field", dest="field", default=None,
                   help="solution-field .sol (not ported yet)")
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
                   help="Morton renumbering (not ported yet)")
    p.add_argument("-noinsert", action="store_true")
    p.add_argument("-noswap", action="store_true")
    p.add_argument("-nomove", action="store_true")
    p.add_argument("-nofrontier", dest="nofrontier", action="store_true",
                   help="full-table sweeps (the only mode of this port "
                   "so far; accepted)")
    p.add_argument("-nosurf", action="store_true",
                   help="freeze the boundary surface exactly")
    p.add_argument("-opnbdy", action="store_true",
                   help="preserve open internal boundaries")
    p.add_argument("-niter", type=int, default=3,
                   help="outer remesh iterations")
    p.add_argument("-nparts", type=int, default=1,
                   help="number of shards, stacked on the one device "
                   "(above 1 only with -nobalance so far)")
    p.add_argument("-nobalance", dest="nobalancing", action="store_true",
                   help="no resharding between iterations (frozen "
                   "interfaces)")
    p.add_argument("-balance", dest="balance_band", type=float,
                   default=None)
    p.add_argument("-nlayers", dest="ifc_layers", type=int, default=None)
    p.add_argument("-groups-ratio", dest="grps_ratio", type=float,
                   default=None)
    p.add_argument("-mesh-size", dest="mesh_size", type=int, default=None,
                   help="minimum elements per shard before the run is "
                   "distributed (smaller meshes grow on one shard first)")
    p.add_argument("-pure-partitioning", action="store_true")
    p.add_argument("-distributed-output", dest="dist_out",
                   action="store_true")
    p.add_argument("-centralized-output", dest="cent_out",
                   action="store_true",
                   help="centralized output (the default of this port)")
    p.add_argument("-distributed-input", dest="dist_in",
                   action="store_true")
    p.add_argument("-ls", type=float, nargs="?", const=0.0, default=None)
    p.add_argument("-ckpt", dest="ckpt", default=None)
    p.add_argument("-ckpt-every", dest="ckpt_every", type=int, default=None)
    p.add_argument("-ckpt-async", dest="ckpt_async", action="store_true")
    return p


# flags of paths not in this slice: (flag, dest, "is set" test, ROADMAP
# item that brings it)
_REFUSED = (
    ("-distributed-output", "dist_out", bool,
     "queue 1, item 12 (distributed I/O)"),
    ("-distributed-input", "dist_in", bool,
     "queue 1, item 12 (distributed I/O)"),
    ("-pure-partitioning", "pure_partitioning", bool,
     "queue 1, item 12 (partitioning output)"),
    ("-rn", "renumber", bool, "queue 1, item 12 (SFC renumbering)"),
    ("-balance", "balance_band", lambda v: v is not None,
     "queue 1, item 10 (load balancing)"),
    ("-nlayers", "ifc_layers", lambda v: v is not None,
     "queue 1, item 10 (interface displacement)"),
    ("-groups-ratio", "grps_ratio", lambda v: v is not None,
     "queue 1, item 10 (repartitioning)"),
    ("-field", "field", lambda v: v is not None,
     "queue 1, item 11 (interp_fields_only)"),
    ("-ls", "ls", lambda v: v is not None, "queue 1, item 11 (level set)"),
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
    if args.nparts > 1 and not args.nobalancing:
        raise NotImplementedError(
            f"-nparts {args.nparts} without -nobalance: the balancing "
            "between iterations is not ported yet — ROADMAP queue 1, "
            "item 10 (interface displacement and graph balancing) brings "
            "it; add -nobalance for frozen interfaces")
    for path in (args.input, args.out):
        if path and path.endswith((".vtu", ".pvtu")):
            raise NotImplementedError(
                f"{path}: VTK I/O is not ported yet — ROADMAP queue 1, "
                "item 11 brings it")


def print_default_values() -> None:
    """`-val`: print the default parameters."""
    from .models.adapt import AdaptOptions

    d = AdaptOptions()
    print("\nDefault parameters values:")
    print("\n** Generic options")
    print("verbosity (-v)          : 1")
    print("\n** Parameters")
    print(f"niter (-niter)          : {d.niter}")
    print("nparts (-nparts)        : 1")
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
    _refuse_unported(args)

    import torch

    from . import resolve_device
    from .io import medit, parsop
    from .models.adapt import adapt
    from .models.distributed import (DistOptions, adapt_distributed,
                                     merge_adapted)
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
        mem_budget_mb=args.mem, frontier=False,
        nparts=args.nparts, nobalancing=args.nobalancing,
        min_shard_elts=args.mesh_size or DistOptions.min_shard_elts,
    )

    with timers.phase("input"):
        mesh = medit.load_mesh(args.input, args.sol, device=device)

    with timers.phase("remeshing"):
        if args.nparts > 1:
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
        print(quality.format_histogram(info["qual_in"],
                                       "INPUT MESH QUALITY"))
        print(quality.format_histogram(info["qual_out"],
                                       "OUTPUT MESH QUALITY"))
        print(quality.format_length_stats(info["len_out"]))

    if not args.noout:
        with timers.phase("output"):
            if args.nparts > 1:
                mesh_out = merge_adapted(stacked, comm)
            medit.save_mesh(mesh_out, out)
            medit.save_met(mesh_out, medit.met_filename(out))
    timers.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
