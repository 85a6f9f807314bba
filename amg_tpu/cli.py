"""Command-line interface.

``python -m amg_tpu matrix.mtx`` reproduces the reference binary's behavior
(``main``, amg/SSS_main.c:121-159): read the matrix, echo parameters, solve
``A x = b`` with ``b = x0 = 1``, print the residual table and final summary.

Unlike the reference (which hard-codes every parameter), every
``AMGParams`` field is exposed as a flag.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .params import (
    AMGParams,
    CoarsenType,
    CoarsestSolver,
    ErrorCode,
    InterpType,
    SmootherType,
)


def pars_print(pars: AMGParams, log=print) -> None:
    """Parameter echo matching ``SSS_amg_pars_print`` (amg/SSS_main.c:67-119)."""
    log("")
    log("               AMG Parameters ")
    log("-----------------------------------------------------------")
    log(f"AMG max num of iter:               {pars.max_it}")
    log(f"AMG tol:                           {pars.tol:g}")
    log(f"AMG ctol:                          {pars.ctol:g}")
    log(f"AMG max levels:                    {pars.max_levels}")
    log(f"AMG cycle type:                    {pars.cycle_type}")
    log(f"AMG smoother type:                 {int(pars.smoother)}")
    log(f"AMG smoother order:                {pars.cf_order}")
    log(f"AMG num of presmoothing:           {pars.pre_iter}")
    log(f"AMG num of postsmoothing:          {pars.post_iter}")
    if pars.smoother in (SmootherType.SOR, SmootherType.SSOR,
                         SmootherType.GSOR, SmootherType.SGSOR):
        log("AMG relax factor:                  %.4f" % pars.relax)
    elif pars.smoother == SmootherType.POLY:
        log(f"AMG polynomial smoother degree:    {pars.poly_deg}")
    log(f"AMG coarsening type:               {int(pars.cs_type)}")
    if pars.interp_type == InterpType.DIR:
        log("AMG interPolation type:            Dir")
    elif pars.interp_type == InterpType.STD:
        log("AMG interPolation type:            STD")
    log(f"AMG dof on coarsest grid:          {pars.coarse_dof}")
    log("AMG strong threshold:              %.4f" % pars.strong_threshold)
    log("AMG truncation threshold:          %.4f" % pars.trunc_threshold)
    log("AMG max row sum:                   %.4f" % pars.max_row_sum)
    log("-----------------------------------------------------------")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="amg_tpu",
        description="Algebraic multigrid solver (JAX)",
    )
    ap.add_argument("matrix", help=".mtx MatrixMarket file, or poisson2d:N / "
                                   "poisson3d:N / anisotropic:N[:eps] / "
                                   "fem2d:N[:graded] synthetic problem")
    d = AMGParams()
    ap.add_argument("--max-it", type=int, default=d.max_it)
    ap.add_argument("--tol", type=float, default=d.tol)
    ap.add_argument("--ctol", type=float, default=d.ctol)
    ap.add_argument("--max-levels", type=int, default=d.max_levels)
    ap.add_argument("--coarse-dof", type=int, default=d.coarse_dof)
    ap.add_argument("--cycle-type", type=int, default=d.cycle_type,
                    help="1=V, 2=W")
    ap.add_argument("--cf-order", type=int, default=d.cf_order)
    ap.add_argument("--pre-iter", type=int, default=d.pre_iter)
    ap.add_argument("--post-iter", type=int, default=d.post_iter)
    ap.add_argument("--relax", type=float, default=d.relax)
    ap.add_argument("--poly-deg", type=int, default=d.poly_deg)
    ap.add_argument("--smoother", type=str, default="GS",
                    choices=[s.name for s in SmootherType])
    ap.add_argument("--coarsen", type=str, default="RS",
                    choices=[c.name for c in CoarsenType])
    ap.add_argument("--interp", type=str, default="DIR",
                    choices=[i.name for i in InterpType])
    ap.add_argument("--coarsest", type=str, default="DENSE",
                    choices=[c.name for c in CoarsestSolver])
    ap.add_argument("--max-row-sum", type=float, default=d.max_row_sum)
    ap.add_argument("--strong-threshold", type=float, default=d.strong_threshold)
    ap.add_argument("--trunc-threshold", type=float, default=d.trunc_threshold)
    ap.add_argument("--dtype", type=str, default=d.dtype,
                    choices=["float32", "float64"])
    ap.add_argument("--refine", action="store_true",
                    help="mixed-precision defect correction: cycles in "
                         "--dtype, f64 outer residual")
    ap.add_argument("--refine-inner", type=int, default=d.refine_inner_cycles)
    ap.add_argument("--accel", type=str, default=d.accel,
                    choices=["none", "cg", "gmres"],
                    help="Krylov acceleration: cg = AMG-preconditioned "
                         "flexible CG (one cycle per iteration); gmres = "
                         "AMG-right-preconditioned GMRES (nonsymmetric)")
    ap.add_argument("--devices", type=int, default=0,
                    help="solve on an N-device mesh (0 = single device)")
    ap.add_argument("--dist", type=str, default="auto",
                    choices=["auto", "spmd", "gspmd"],
                    help="multi-device path: spmd = hand-placed shard_map "
                         "cycle (fewest collectives; needs an embedded "
                         "hierarchy), gspmd = sharding-annotated solver; "
                         "auto tries spmd first")
    ap.add_argument("--use-well", type=str, default=d.use_well,
                    choices=["auto", "on", "off"],
                    help="windowed-gather WEll format for large "
                         "unstructured levels")
    ap.add_argument("--transfer-dtype", type=str,
                    default=d.transfer_op_dtype,
                    choices=["same", "bfloat16"],
                    help="P/R value-plane storage on WEll levels "
                         "(bfloat16 halves them; the 10M-row HBM-fit "
                         "knob)")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="capture a jax profiler trace of the solve to DIR")
    ap.add_argument("--quiet", action="store_true")
    return ap


def params_from_args(args) -> AMGParams:
    return AMGParams(
        smoother=SmootherType[args.smoother],
        max_it=args.max_it,
        tol=args.tol,
        ctol=args.ctol,
        max_levels=args.max_levels,
        coarse_dof=args.coarse_dof,
        cycle_type=args.cycle_type,
        cf_order=args.cf_order,
        pre_iter=args.pre_iter,
        post_iter=args.post_iter,
        relax=args.relax,
        poly_deg=args.poly_deg,
        cs_type=CoarsenType[args.coarsen],
        interp_type=InterpType[args.interp],
        coarsest_solver=CoarsestSolver[args.coarsest],
        max_row_sum=args.max_row_sum,
        strong_threshold=args.strong_threshold,
        trunc_threshold=args.trunc_threshold,
        dtype=args.dtype,
        refine=args.refine,
        refine_inner_cycles=args.refine_inner,
        accel=args.accel,
        use_well=args.use_well,
        transfer_op_dtype=args.transfer_dtype,
        verbose=0 if args.quiet else 1,
    )


def load_matrix(spec: str):
    from .io import read_mtx, poisson2d, poisson3d

    if spec.startswith("poisson2d:"):
        return poisson2d(int(spec.split(":", 1)[1]))
    if spec.startswith("poisson3d:"):
        return poisson3d(int(spec.split(":", 1)[1]))
    if spec.startswith("fem2d:"):
        # fem2d:N or fem2d:N:graded — unstructured Delaunay FEM stiffness
        from .io.generators import fem2d

        parts = spec.split(":")
        return fem2d(int(parts[1]), graded=len(parts) > 2 and
                     parts[2] == "graded")
    if spec.startswith("anisotropic:"):
        # anisotropic:N or anisotropic:N:eps (epsilon-scaled y-coupling)
        parts = spec.split(":")
        eps = float(parts[2]) if len(parts) > 2 else 1e-3
        return poisson2d(int(parts[1]), epsilon=eps)
    return read_mtx(spec)


def main(argv=None) -> int:
    import os

    import jax

    # persistent compile cache: the unrolled V-cycle program is expensive
    # to compile; reuse it across runs
    from amg_tpu.compile_cache import enable as _enable_cache
    _enable_cache()

    args = build_argparser().parse_args(argv)
    pars = params_from_args(args)

    print(f"filename: {args.matrix}")
    try:
        a = load_matrix(args.matrix)
    except FileNotFoundError:
        # reference exits with ERROR_OPEN_FILE (amg/SSS_main.c:131-137)
        print(f"amg_tpu: cannot open matrix file '{args.matrix}'",
              file=sys.stderr)
        return int(-ErrorCode.ERROR_OPEN_FILE)
    except ValueError as exc:
        print(f"amg_tpu: bad matrix input: {exc}", file=sys.stderr)
        return int(-ErrorCode.ERROR_WRONG_FILE)
    print(f"A: m = {a.n_rows}, n = {a.n_cols}, nnz = {a.nnz}")

    if pars.verbose:
        pars_print(pars)

    # b = x0 = ones, like the reference CLI (amg/SSS_main.c:141-145)
    b = np.ones(a.n_rows)
    x0 = np.ones(a.n_rows)

    import contextlib

    prof = (jax.profiler.trace(args.profile) if args.profile
            else contextlib.nullcontext())
    with prof:
        if args.devices and args.devices > 1:
            from .parallel import DistAMGSolver, make_mesh

            solver = None
            if args.dist in ("auto", "spmd"):
                # preferred multi-chip path: the hand-placed shard_map
                # cycle runs ~17x fewer collective-permutes per cycle
                # than the GSPMD-annotated solver (ROADMAP audit)
                from .parallel.spmd_cycle import SpmdAMGSolver

                try:
                    solver = SpmdAMGSolver(a, pars,
                                           mesh=make_mesh(args.devices))
                except ValueError as exc:
                    if args.dist == "spmd":
                        raise
                    print(f"# spmd path unavailable ({exc}); "
                          "using the GSPMD solver")
            if solver is None:
                solver = DistAMGSolver(a, pars, mesh=make_mesh(args.devices))
            x, info = solver.solve(b, x0=x0)
        else:
            from .solve.driver import solver_amg

            x, info = solver_amg(a, x0, b, pars)

    print(f"AMG residual: {info.ares:g}")
    print(f"AMG relative residual: {info.rres:g}")
    print(f"AMG iterations: {info.nits}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
