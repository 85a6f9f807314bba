"""Multigrid V/W-cycle, fully jittable.

Replicates the reference's non-recursive counter/goto cycle
(``SSS_amg_cycle``, amg/Solve/SSS_cycle.cu:848-967) as a recursion that
unrolls at trace time: level count and shapes are static, so XLA sees one
straight-line program of sparse products, elementwise arithmetic and (at
the coarsest level) one small dense matvec.  Per reference semantics, level 0 runs
its block once per cycle call and deeper levels repeat their block
``cycle_type`` times per parent visit (V=1, W=2).

The coarsest solve is either a dense inverse apply (default; the
reference's coarsest grids are ~10-1000 rows) or reference-style CG with
GMRES fallback (``SSS_amg_coarest_solve``, amg/Solve/SSS_cycle.cu:819-846).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..params import AMGParams, CoarsestSolver
from ..hierarchy import Hierarchy
from ..ops.blas import HIGHEST
from ..ops.spmv import spmv, residual
from .smoothers import smooth


def coarsest_solve(mg: Hierarchy, b: jnp.ndarray, pars: AMGParams, ctol):
    """Solve the coarsest system."""
    if pars.coarsest_solver == CoarsestSolver.DENSE:
        return jnp.matmul(mg.coarse_inv, b, precision=HIGHEST)
    from .krylov import cg, gmres

    level = mg.levels[-1]
    n = level.n
    # maxit = max(250, min(n*n, 1000)) (amg/Solve/SSS_cycle.cu:822)
    maxit = max(250, min(n * n, 1000))
    x0 = jnp.zeros_like(b)
    x, ok = cg(level.a, b, x0, tol=ctol, maxit=maxit)
    # GMRES fallback runs ONLY when CG failed (amg/Solve/SSS_cycle.cu:837-841)
    import jax

    def _fallback(_):
        xg, _ok = gmres(level.a, b, x0, tol=ctol, maxit=maxit, restart=30)
        return xg

    return jax.lax.cond(ok, lambda _: x, _fallback, operand=None)


def cycle(mg: Hierarchy, x: jnp.ndarray, b: jnp.ndarray, pars: AMGParams):
    """One multigrid cycle on level 0. Returns updated x (padded length)."""
    ctol = min(pars.ctol, pars.tol * 0.1) if pars.ctol > pars.tol else pars.ctol
    return _cycle_level(mg, 0, x, b, pars, ctol)


def _cycle_level(mg: Hierarchy, l: int, x, b, pars: AMGParams, ctol):
    nl = mg.num_levels
    if l == nl - 1:
        return coarsest_solve(mg, b, pars, ctol)

    level = mg.levels[l]
    repeats = 1 if l == 0 else max(pars.cycle_type, 1)
    # coarse-level smoother override (e.g. Chebyshev on embedded levels,
    # where masked GS would cost n_colors operator passes per sweep)
    pars_l = pars if (l == 0 or pars.coarse_smoother is None) \
        else pars.replace(smoother=pars.coarse_smoother)
    if pars.poly_deg_schedule is not None:
        sched = pars.poly_deg_schedule
        pars_l = pars_l.replace(poly_deg=sched[min(l, len(sched) - 1)])

    for _ in range(repeats):
        # pre-smoothing
        x = smooth(level, x, b, pars_l, pars.pre_iter, pre=True)
        # restrict residual
        r = residual(level.a, x, b)
        if level.member_idx is not None:
            # compact boundary: gather the residual at this level's member
            # positions (n_E-sized — small), then compact Ell restriction.
            # Gather padding slots clamp to an arbitrary entry; the compact
            # P rows are static so mask by its true row count.
            rc = r[level.member_idx]
            rc = jnp.where(
                jnp.arange(rc.shape[0]) < level.p.n_rows, rc, 0.0)
            bc = spmv(level.r, rc)
            nn = mg.levels[l + 1].n
            bc = jnp.where(jnp.arange(bc.shape[0]) < nn, bc, 0.0)
        else:
            bc = spmv(level.r, r)
            if level.compact_idx is not None:
                # fine-grid-embedded -> compact boundary (one small
                # gather); padding slots clamp, so mask them off
                bc = bc[level.compact_idx]
                nn = mg.levels[l + 1].n
                bc = jnp.where(jnp.arange(bc.shape[0]) < nn, bc, 0.0)
        xc = jnp.zeros_like(bc)
        # coarse correction
        xc = _cycle_level(mg, l + 1, xc, bc, pars, ctol)
        if level.member_idx is not None:
            # compact prolongation on the short vector, then scatter-add
            # back into the embedded index space (padding drops)
            xe_c = spmv(level.p, xc)
            x = x.at[level.member_idx].add(
                xe_c.astype(x.dtype), mode="drop")
        elif level.compact_idx is not None:
            # compact -> embedded (one small scatter; padding drops)
            xe = jnp.zeros_like(x).at[level.compact_idx].set(
                xc, mode="drop")
            x = x + spmv(level.p, xe)
        else:
            x = x + spmv(level.p, xc)
        # post-smoothing
        x = smooth(level, x, b, pars_l, pars.post_iter, pre=False)
    return x
