"""Smoothers.

The reference dispatches nine smoother types but only sequential
Gauss-Seidel is live (amg/Solve/SSS_smooth.c:138-220; the comment at
amg/Solve/SSS_cycle.cu:882 concedes "smoothing could't use cuda").

Here every smoother is a jit-safe function over the device
:class:`~amg_tpu.solve.hierarchy.Level`:

* **Multicolor Gauss-Seidel** (default, matches ``SSS_SM_GS``): exact GS in
  the colored ordering — per color group, a gathered row-block update.
  C/F ordering (``cf_order=1``) replicates the reference's F-then-C
  pre-smooth and C-then-F post-smooth (amg/Solve/SSS_smooth.c:4-87).
* SGS, SOR, SSOR, GSOR, SGSOR: symmetric / relaxed variants on the same
  machinery (reference enum amg/SSS_main.h:133-145).
* Jacobi / weighted Jacobi / L1-Jacobi: purely data-parallel, one fused
  SpMV + axpy.
* Chebyshev polynomial smoothing (``SSS_SM_POLY`` analog) using Jacobi
  preconditioning and a spectral-radius estimate computed at setup.

All updates are expressed as sparse products + elementwise arithmetic;
there is no sequential scan anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.blas import HIGHEST
from ..params import SmootherType
from ..sparse import Dia, Dense, BandedBlocks, WEll


def _masked_group_update(level, x, b, g: int, relax=None):
    """Gauss-Seidel update of group ``g`` on a gather-free format.

    One full SpMV, then a masked update of the group's rows.
    ``t_i = (b_i - (Ax)_i + a_ii x_i) / a_ii`` is the exact GS update
    because rows within a group are mutually independent.  XLA fuses the
    product, the update and the select into one pass over the operator.
    """
    from ..ops.spmv import spmv

    ax = spmv(level.a, x)
    t = (b - ax + level.diag * x) * level.inv_diag
    if relax is not None:
        t = (1.0 - relax) * x + relax * t
    upd = (level.gid == g) & (level.inv_diag != 0)
    return jnp.where(upd, t, x)


def _group_update(level, x, b, idx, relax=None):
    """Gauss-Seidel update of one independent group of rows.

    x[i] <- (b[i] - sum_{j != i} a_ij x_j) / a_ii  for i in idx.
    Padding entries of idx equal the padded length (out of bounds): their
    scatter is dropped.
    """
    a = level.a
    sub_cols = a.cols[idx]            # (g, w)
    sub_vals = a.vals[idx]            # (g, w)
    sub_diag_mask = level.diag_mask[idx]
    gathered = x[sub_cols]
    off = jnp.where(sub_diag_mask, jnp.zeros((), a.vals.dtype), sub_vals)
    t = b[idx] - jnp.sum(off * gathered, axis=1)
    invd = level.inv_diag[idx]
    new = t * invd
    if relax is not None:
        new = (1.0 - relax) * x[idx] + relax * new
    # small-diagonal guard: keep old value (reference gs_cf,
    # amg/Solve/SSS_smooth.c:30)
    new = jnp.where(invd != 0, new, x[idx])
    return x.at[idx].set(new, mode="drop")


def _range_update(level, x, b, start: int, size: int, relax=None):
    """Gauss-Seidel update of one color-contiguous row range (static slice).

    Used when the level was permuted by ``reorder_for_gs``: rows
    ``[start, start+size)`` form one independent class, so the update is
    exact GS with no index gather, no scatter, and no padding waste — one
    full sweep over all ranges costs one SpMV's worth of work.
    """
    a = level.a
    w = a.cols.shape[1]
    sub_cols = jax.lax.slice(a.cols, (start, 0), (start + size, w))
    sub_vals = jax.lax.slice(a.vals, (start, 0), (start + size, w))
    sub_dmask = jax.lax.slice(level.diag_mask, (start, 0), (start + size, w))
    gathered = x[sub_cols]
    off = jnp.where(sub_dmask, jnp.zeros((), a.vals.dtype), sub_vals)
    t = jax.lax.slice(b, (start,), (start + size,)) - jnp.sum(
        off * gathered, axis=1
    )
    invd = jax.lax.slice(level.inv_diag, (start,), (start + size,))
    new = t * invd
    old = jax.lax.slice(x, (start,), (start + size,))
    if relax is not None:
        new = (1.0 - relax) * old + relax * new
    new = jnp.where(invd != 0, new, old)
    return jax.lax.dynamic_update_slice(x, new, (start,))


def _range_update_dense(level, x, b, start: int, size: int, relax=None):
    """Range GS update on a Dense level: one static-slice matvec.

    Within a color class A has no intra-class couplings, so the full-row
    product plus add-back of the diagonal term is the exact GS update.
    """
    a = level.a
    sub = jax.lax.slice(a.vals, (start, 0), (start + size, a.padded_cols))
    ax = jnp.matmul(sub, x[: a.padded_cols], precision=HIGHEST)
    bs = jax.lax.slice(b, (start,), (start + size,))
    ds = jax.lax.slice(level.diag, (start,), (start + size,))
    invd = jax.lax.slice(level.inv_diag, (start,), (start + size,))
    old = jax.lax.slice(x, (start,), (start + size,))
    new = (bs - ax + ds * old) * invd
    if relax is not None:
        new = (1.0 - relax) * old + relax * new
    new = jnp.where(invd != 0, new, old)
    return jax.lax.dynamic_update_slice(x, new, (start,))


def gs_sweep(level, x, b, order, relax=None):
    """One GS sweep over groups in the given (static) order."""
    if level.ranges is not None:
        upd = (_range_update_dense if isinstance(level.a, Dense)
               else _range_update)
        for g in order:
            start, size = level.ranges[g]
            x = upd(level, x, b, start, size, relax=relax)
    elif isinstance(level.a, (Dia, Dense, BandedBlocks, WEll)):
        for g in order:
            x = _masked_group_update(level, x, b, g, relax=relax)
    else:
        for g in order:
            x = _group_update(level, x, b, level.groups[g], relax=relax)
    return x


def _order(level, forward: bool, cf_order: int, pre: bool):
    """Static group ordering.

    cf_order=1: pre-smooth visits F groups then C groups, post-smooth C
    then F (reference amg/Solve/SSS_smooth.c:171,256).  cf_order=0: color
    order, reversed for the backward sweep.
    """
    ng = len(level.group_cf)
    ids = list(range(ng))
    if cf_order == 1:
        f = [g for g in ids if level.group_cf[g] == 0]
        c = [g for g in ids if level.group_cf[g] == 1]
        return tuple(f + c) if pre else tuple(c + f)
    return tuple(ids) if forward else tuple(reversed(ids))


def _jacobi(level, x, b, weight):
    from ..ops.spmv import spmv

    r = b - spmv(level.a, x)
    return x + weight * level.inv_diag * r


def _l1_jacobi(level, x, b):
    from ..ops.spmv import spmv

    r = b - spmv(level.a, x)
    return x + level.l1_inv * r


def _chebyshev(level, x, b, degree):
    """Chebyshev smoothing on the Jacobi-preconditioned operator, targeting
    the upper part [rho/4, rho] of the spectrum (standard AMG practice)."""
    from ..ops.spmv import spmv

    rho = level.rho_dinv_a  # spectral radius estimate of D^{-1} A
    theta = 0.5 * (rho + rho / 4.0)
    delta = 0.5 * (rho - rho / 4.0)
    sigma = theta / delta
    rho_old = 1.0 / sigma

    r = level.inv_diag * (b - spmv(level.a, x))
    d = r / theta
    x = x + d
    for _ in range(max(degree - 1, 0)):
        rho_new = 1.0 / (2.0 * sigma - rho_old)
        r = level.inv_diag * (b - spmv(level.a, x))
        d = rho_new * rho_old * d + 2.0 * rho_new / delta * r
        x = x + d
        rho_old = rho_new
    return x


def _cg_smooth(level, x, b, nsweeps, axis_name=None, spmv_fn=None):
    """Krylov smoothing: ``nsweeps`` steps of Jacobi-preconditioned CG on
    A x = b from the incoming iterate (``SSS_SM_CG``, reference enum
    amg/SSS_main.h:133-145 — declared there, dead in its dispatch).

    Fixed iteration count, no convergence test: jit-safe by construction.
    Note CG smoothing is a *nonlinear* operation, so the outer Krylov wrap
    (if any) should be flexible (FCG / FGMRES) — same caveat as any
    variable preconditioner.
    """
    from ..ops.spmv import spmv as _spmv
    from ..ops.blas import dot

    apply_a = spmv_fn if spmv_fn is not None else (
        lambda v: _spmv(level.a, v))
    eps = jnp.asarray(1e-30, x.dtype)
    r = b - apply_a(x)
    z = level.inv_diag * r
    p = z
    rz = dot(r, z, axis_name)
    for _ in range(nsweeps):
        ap = apply_a(p)
        alpha = rz / (dot(p, ap, axis_name) + eps)
        x = x + alpha * p
        r = r - alpha * ap
        z = level.inv_diag * r
        rz_new = dot(r, z, axis_name)
        p = z + (rz_new / (rz + eps)) * p
        rz = rz_new
    return x


def smooth(level, x, b, pars, nsweeps: int, pre: bool):
    """Apply ``nsweeps`` of the configured smoother.

    Dispatch mirrors ``SSS_amg_smoother_pre/post``
    (amg/Solve/SSS_smooth.c:138-304); every branch implemented (the
    reference errors out on all but GS).
    """
    sm = pars.smoother
    relax = pars.relax

    if sm in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        # a degree-d Chebyshev application IS the smoother; iterating it
        # nsweeps times would restart the recurrence (same work as degree
        # nsweeps*d but weaker) — apply once per pre/post call
        return _chebyshev(level, x, b, pars.poly_deg)

    if sm == SmootherType.CG:
        return _cg_smooth(level, x, b, nsweeps)

    for _ in range(nsweeps):
        if sm == SmootherType.GS:
            x = gs_sweep(level, x, b, _order(level, pre, pars.cf_order, pre))
        elif sm == SmootherType.SGS:
            x = gs_sweep(level, x, b, _order(level, True, 0, True))
            x = gs_sweep(level, x, b, _order(level, False, 0, False))
        elif sm == SmootherType.JACOBI:
            x = _jacobi(level, x, b, 1.0)
        elif sm == SmootherType.WJACOBI:
            x = _jacobi(level, x, b, relax)
        elif sm == SmootherType.L1DIAG:
            x = _l1_jacobi(level, x, b)
        elif sm == SmootherType.SOR:
            x = gs_sweep(level, x, b, _order(level, pre, pars.cf_order, pre),
                         relax=relax)
        elif sm == SmootherType.SSOR:
            x = gs_sweep(level, x, b, _order(level, True, 0, True), relax=relax)
            x = gs_sweep(level, x, b, _order(level, False, 0, False), relax=relax)
        elif sm == SmootherType.GSOR:
            x = gs_sweep(level, x, b, _order(level, pre, pars.cf_order, pre))
            x = gs_sweep(level, x, b, _order(level, pre, pars.cf_order, pre),
                         relax=relax)
        elif sm == SmootherType.SGSOR:
            x = gs_sweep(level, x, b, _order(level, True, 0, True))
            x = gs_sweep(level, x, b, _order(level, False, 0, False))
            x = gs_sweep(level, x, b, _order(level, True, 0, True), relax=relax)
            x = gs_sweep(level, x, b, _order(level, False, 0, False), relax=relax)
        else:
            raise ValueError(f"unsupported smoother {sm}")
    return x
