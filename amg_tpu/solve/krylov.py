"""Krylov solvers (jittable, device-resident).

Replicas of the reference's coarsest-level solvers with the textbook-correct
numerics (the reference's CG beta uses an uninitialized GPU buffer,
amg/Solve/SSS_cycle.cu:373-374 — SURVEY.md "bugs to NOT replicate"):

* :func:`cg` — preconditioned conjugate gradients with the reference's
  safety nets expressed as loop-carried state: best-solution tracking
  (amg/Solve/SSS_cycle.cu:238-242) and divergence detection.
* :func:`gmres` — restarted GMRES with modified Gram-Schmidt and Givens
  rotations (amg/Solve/SSS_cycle.cu:440-817).

Both are pure functions of padded device arrays, run entirely under ``jit``
(``lax.while_loop`` over iterations), and reduce with ``psum`` when an
``axis_name`` is supplied so the same code serves the sharded solver.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..params import SMALLFLOAT, MAX_STAG, MAX_RESTART, ErrorCode
from ..sparse import Ell, Dia, Dense, BandedBlocks
from ..ops.spmv import spmv
from ..ops.blas import HIGHEST, dot, norm2, norminf

_SMALLFLOAT2 = 1e-40  # breakdown tolerance (reference SMALLFLOAT2)

# status values for the CG state machine (loop-carried scalar)
_RUNNING = 0
_CONVERGED = 1
_BREAKDOWN = 2


def _as_op(a):
    if isinstance(a, (Ell, Dia, Dense, BandedBlocks)):
        return lambda v: spmv(a, v)
    return a


def cg(a, b, x0, tol=1e-7, maxit=250, M=None, axis_name=None,
       stop_type=None, return_info=False):
    """Conjugate gradients with the reference's full safety-net state machine.

    ``a`` is an :class:`Ell` or a matvec callable; ``M`` an optional
    preconditioner callable (z = M(r)).  ``stop_type`` replicates the
    reference's three criteria (amg/Solve/SSS_cycle.cu:101-130):

    * ``REL_RES`` (default): ``||r|| / max(eps, ||r0||) < tol``
    * ``REL_PRECRES``: ``sqrt(r.z) / sqrt(r0.z0) < tol`` (B-norm)
    * ``MOD_REL_RES``: ``||r|| / max(eps, ||x||) < tol``

    Safety nets, expressed as loop-carried scalar state so the whole loop
    stays one ``lax.while_loop`` (reference amg/Solve/SSS_cycle.cu:238-355):

    * best-solution tracking and final restore (:238-242, :381-419);
    * Check I — near-zero solution => ``ERROR_SOLVER_SOLSTAG`` (:245-249);
    * Check II — stagnation (``|alpha| ||p|| / ||x|| < tol*1e-4``):
      recompute the *true* residual ``b - A x``; accept if converged, else
      restart with ``p = 0`` up to ``MAX_STAG`` times, then
      ``ERROR_SOLVER_STAG`` (:252-308);
    * Check III — false convergence: when the recurrence residual passes
      ``tol``, verify against the recomputed true residual before
      accepting; on failure restart up to ``MAX_RESTART`` times, then
      ``ERROR_SOLVER_TOLSMALL`` (:311-355).

    The true-residual recompute runs under ``lax.cond`` so the extra SpMV
    is only paid on iterations that trigger a check.

    Returns ``(x, converged)``, or ``(x, converged, info)`` with
    ``return_info`` where ``info = (status_code, iters)`` and
    ``status_code`` is 1 on convergence, ``ErrorCode.ERROR_SOLVER_*`` on a
    safety-net exit, 0 when ``maxit`` was exhausted.
    """
    from ..params import StopType

    amul = _as_op(a)
    prec = M if M is not None else (lambda v: v)
    st = StopType.REL_RES if stop_type is None else stop_type
    maxdiff = tol * 1e-4            # stagnation tolerance (reference :27)
    sol_inf_tol = SMALLFLOAT        # Check-I tolerance (reference :28)

    r0 = b - amul(x0)
    z0 = prec(r0)
    absres0 = norm2(r0, axis_name)
    normr0 = jnp.maximum(SMALLFLOAT, absres0)
    rho0 = dot(z0, r0, axis_name)
    prec0 = jnp.maximum(SMALLFLOAT, jnp.sqrt(jnp.abs(rho0)))

    def _absres(x, r, z):
        if st == StopType.REL_PRECRES:
            return jnp.sqrt(jnp.abs(dot(z, r, axis_name)))
        return norm2(r, axis_name)

    def _relres(x, absres):
        if st == StopType.MOD_REL_RES:
            return absres / jnp.maximum(SMALLFLOAT, norm2(x, axis_name))
        return absres / normr0

    def cond(c):
        (x, r, z, p, rho, it, best_x, best_res, stag, more_step,
         status) = c
        return (status == _RUNNING) & (it < maxit)

    def body(c):
        (x, r, z, p, rho, it, best_x, best_res, stag, more_step,
         status) = c
        t = amul(p)
        denom = dot(p, t, axis_name)
        breakdown = jnp.abs(denom) <= _SMALLFLOAT2
        alpha = jnp.where(breakdown, 0.0,
                          rho / jnp.where(breakdown, 1.0, denom))
        x = x + alpha * p
        r = r - alpha * t
        zr = prec(r)
        absres = _absres(x, r, zr)
        relres = _relres(x, absres)

        # best-solution tracking (reference :238-242)
        better = absres < best_res - maxdiff
        best_x = jnp.where(better, x, best_x)
        best_res = jnp.where(better, absres, best_res)

        # Check I: solution close to zero (reference :245-249)
        sol_stag = norminf(x, axis_name) <= sol_inf_tol

        # Check II trigger: stagnation (reference :252-256)
        normu = jnp.maximum(SMALLFLOAT, norm2(x, axis_name))
        reldiff = jnp.abs(alpha) * norm2(p, axis_name) / normu
        stag_trig = (stag <= MAX_STAG) & (reldiff < maxdiff)

        # Check III trigger: recurrence says converged (reference :311).
        # Both checks re-verify against the TRUE residual b - A x; compute
        # it once under lax.cond so untriggered iterations skip the SpMV.
        conv_trig = relres < tol
        need_true = (stag_trig | conv_trig) & ~breakdown & ~sol_stag
        r_true = jax.lax.cond(need_true, lambda: b - amul(x), lambda: r)
        z_true = prec(r_true)
        abs_true = _absres(x, r_true, z_true)
        rel_true = _relres(x, abs_true)

        verified = need_true & (rel_true < tol)
        stag_fail = stag_trig & ~verified & (stag >= MAX_STAG)
        stag_restart = stag_trig & ~verified & (stag < MAX_STAG)
        false_conv = conv_trig & ~stag_trig & ~verified
        tol_fail = false_conv & (more_step >= MAX_RESTART)
        restart = (stag_restart | (false_conv & ~tol_fail)) & ~breakdown

        # adopt the recomputed residual when it was computed (reference
        # overwrites r in place at :258-260, :313-315)
        r = jnp.where(need_true, r_true, r)
        zr = jnp.where(need_true, z_true, zr)

        # priority: breakdown > converged > Check I > Check II fail >
        # Check III fail > keep running
        status = jnp.where(
            breakdown, _BREAKDOWN,
            jnp.where(
                verified, _CONVERGED,
                jnp.where(
                    sol_stag, int(ErrorCode.ERROR_SOLVER_SOLSTAG),
                    jnp.where(
                        stag_fail, int(ErrorCode.ERROR_SOLVER_STAG),
                        jnp.where(tol_fail,
                                  int(ErrorCode.ERROR_SOLVER_TOLSMALL),
                                  _RUNNING))))).astype(jnp.int32)

        rho_new = dot(zr, r, axis_name)
        beta = jnp.where(rho != 0, rho_new / jnp.where(rho != 0, rho, 1.0),
                         0.0)
        p = jnp.where(restart, 0.0, 1.0) * p * beta + zr
        stag = stag + jnp.where(stag_restart, 1, 0)
        more_step = more_step + jnp.where(false_conv & ~tol_fail, 1, 0)
        return (x, r, zr, p, rho_new, it + 1, best_x, best_res, stag,
                more_step, status)

    one = jnp.ones((), jnp.int32)
    init = (x0, r0, z0, z0, rho0, jnp.zeros((), jnp.int32), x0, absres0,
            one, one, jnp.full((), _RUNNING, jnp.int32))
    (x, r, z, p, rho, it, best_x, best_res, stag, more_step,
     status) = jax.lax.while_loop(cond, body, init)
    converged = status == _CONVERGED
    # restore best solution when the final iterate is worse (reference
    # best-solution net, amg/Solve/SSS_cycle.cu:381-419)
    absres = _absres(x, r, z)
    x = jnp.where(absres <= best_res + maxdiff, x, best_x)
    if return_info:
        return x, converged, (status, it)
    return x, converged


def fcg_init(amul, prec, b, x0, axis_name=None):
    """Initial state for flexible CG: ``(x, r, z, p, rho)``."""
    r0 = b - amul(x0)
    z0 = prec(r0)
    rho0 = dot(z0, r0, axis_name)
    return (x0, r0, z0, z0, rho0)


def fcg_step(amul, prec, state, axis_name=None):
    """One flexible-CG iteration (Notay's FCG / IPCG).

    Flexible CG tolerates a *variable* preconditioner — exactly what one AMG
    V-cycle in low precision with Krylov coarsest solves is — by computing
    beta with the Polak-Ribiere form ``<z_new, r_new - r_old> / <z_old,
    r_old>`` instead of the Fletcher-Reeves ratio.  Costs one extra dot per
    iteration vs. standard PCG.

    Returns ``(state, absres)``.
    """
    x, r, z, p, rho = state
    q = amul(p)
    denom = dot(p, q, axis_name)
    alpha = jnp.where(denom != 0, dot(p, r, axis_name)
                      / jnp.where(denom != 0, denom, 1.0), 0.0)
    x = x + alpha * p
    r_new = r - alpha * q
    z_new = prec(r_new)
    rho_new = dot(z_new, r_new, axis_name)
    # <z_new, r_new - r_old> = <z_new, -alpha q>
    rho_pr = rho_new - dot(z_new, r, axis_name)
    beta = jnp.where(rho != 0, rho_pr / jnp.where(rho != 0, rho, 1.0), 0.0)
    p = z_new + beta * p
    return (x, r_new, z_new, p, rho_new), norm2(r_new, axis_name)


def fcg_refresh(amul, prec, b, state, axis_name=None):
    """Residual replacement: recompute ``r = b - A x`` from scratch.

    The FCG recurrence's residual drifts from the true residual by
    accumulated f64 rounding (~eps * kappa); at kappa ~ 1e9 (10M-row FEM
    with 1e3 conductivity jumps) the recursive norm reached 3e-10 while
    the true residual stalled at 6e-8.  Periodic replacement (and a
    replacement before accepting convergence) bounds the gap — the
    same defense as the reference CG's false-convergence Check III
    (amg/Solve/SSS_cycle.cu:311-355).  Keeps the search direction (FCG's
    Polak-Ribiere beta tolerates the perturbation).
    """
    x, r, z, p, rho = state
    r = b - amul(x)
    z = prec(r)
    rho = dot(z, r, axis_name)
    return (x, r, z, p, rho), norm2(r, axis_name)


def fcg(a, b, x0, tol=1e-7, maxit=100, M=None, axis_name=None):
    """Flexible preconditioned CG under one ``lax.while_loop``.

    Returns ``(x, nits, absres)``.  Stopping: ``||r|| / ||b|| < tol``
    (the AMG outer-loop criterion, amg/Solve/SSS_SOLVE.c:64-79, not the
    coarsest-CG criterion).
    """
    amul = _as_op(a)
    prec = M if M is not None else (lambda v: v)
    sumb = jnp.maximum(norm2(b, axis_name), SMALLFLOAT)
    st0 = fcg_init(amul, prec, b, x0, axis_name)
    absres0 = norm2(st0[1], axis_name)

    def cond(c):
        st, it, absres = c
        return (it < maxit) & (absres / sumb >= tol)

    def body(c):
        st, it, absres = c
        st, absres = fcg_step(amul, prec, st, axis_name)
        # periodic residual replacement, same cadence as the host-loop
        # driver (fcg_refresh docstring: bounds recursive drift)
        st, absres = jax.lax.cond(
            (it + 1) % 10 == 0,
            lambda s: fcg_refresh(amul, prec, b, s, axis_name),
            lambda s: (s, norm2(s[1], axis_name)),
            st)
        return (st, it + 1, absres)

    st, it, absres = jax.lax.while_loop(
        cond, body, (st0, jnp.zeros((), jnp.int32), absres0))
    return st[0], it, absres


def gmres(a, b, x0, tol=1e-7, maxit=1000, restart=30, M=None, axis_name=None,
          return_iters=False):
    """Restarted GMRES(m) with MGS + Givens. Returns ``(x, converged)``
    (or ``(x, converged, iters)`` with ``return_iters``).  ``M`` is applied
    as a RIGHT preconditioner (e.g. one AMG cycle), so the residual being
    driven down is the true residual."""
    amul = _as_op(a)
    prec = M if M is not None else (lambda v: v)
    m = restart
    n = b.shape[0]
    dtype = b.dtype

    r0 = b - amul(x0)
    beta0 = norm2(r0, axis_name)
    normr0 = jnp.maximum(SMALLFLOAT, beta0)

    def outer_cond(c):
        x, it, res, conv = c
        return (it < maxit) & (~conv)

    def outer_body(c):
        x, it, res, conv = c
        r = b - amul(x)
        beta = norm2(r, axis_name)

        V = jnp.zeros((m + 1, n), dtype)
        V = V.at[0].set(r / jnp.maximum(beta, SMALLFLOAT))
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)

        def arnoldi(j, st):
            V, H, cs, sn, g, done, k_eff = st
            w = amul(prec(V[j]))
            # modified Gram-Schmidt against all previous basis vectors
            def mgs(i, wh):
                w, hcol = wh
                hij = dot(V[i], w, axis_name)
                # only orthogonalize against built vectors (i <= j)
                hij = jnp.where(i <= j, hij, 0.0)
                w = w - hij * V[i]
                hcol = hcol.at[i].set(hij)
                return (w, hcol)

            w, hcol = jax.lax.fori_loop(0, m + 1, mgs, (w, jnp.zeros((m + 1,), dtype)))
            hj1 = norm2(w, axis_name)
            hcol = hcol.at[j + 1].set(hj1)
            V = V.at[j + 1].set(
                jnp.where(hj1 > SMALLFLOAT, w / jnp.maximum(hj1, SMALLFLOAT), w)
            )

            # apply previous Givens rotations to the new column
            def giv(i, hc):
                hi = cs[i] * hc[i] + sn[i] * hc[i + 1]
                hi1 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                sel = i < j
                hc = hc.at[i].set(jnp.where(sel, hi, hc[i]))
                hc = hc.at[i + 1].set(jnp.where(sel, hi1, hc[i + 1]))
                return hc

            hcol = jax.lax.fori_loop(0, m, giv, hcol)

            # new rotation annihilating hcol[j+1]
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c_new = jnp.where(denom > SMALLFLOAT, hcol[j] / jnp.maximum(denom, SMALLFLOAT), 1.0)
            s_new = jnp.where(denom > SMALLFLOAT, hcol[j + 1] / jnp.maximum(denom, SMALLFLOAT), 0.0)
            cs = cs.at[j].set(jnp.where(done, cs[j], c_new))
            sn = sn.at[j].set(jnp.where(done, sn[j], s_new))
            hcol = hcol.at[j].set(c_new * hcol[j] + s_new * hcol[j + 1])
            hcol = hcol.at[j + 1].set(0.0)
            H = H.at[:, j].set(jnp.where(done, H[:, j], hcol))

            gj1 = -s_new * g[j]
            gj = c_new * g[j]
            g = g.at[j].set(jnp.where(done, g[j], gj))
            g = g.at[j + 1].set(jnp.where(done, g[j + 1], gj1))

            new_done = done | (jnp.abs(gj1) / normr0 < tol) | (hj1 <= SMALLFLOAT)
            k_eff = jnp.where(done, k_eff, j + 1)
            return (V, H, cs, sn, g, new_done, k_eff)

        st = (V, H, cs, sn, g, jnp.zeros((), bool), jnp.zeros((), jnp.int32))
        V, H, cs, sn, g, done, k_eff = jax.lax.fori_loop(0, m, arnoldi, st)

        # back-substitution on the k_eff x k_eff triangular system (masked)
        y = jnp.zeros((m,), dtype)

        def backsub(idx, y):
            jj = m - 1 - idx
            act = jj < k_eff
            s = g[jj] - jnp.dot(H[jj, :], y, precision=HIGHEST)
            hjj = H[jj, jj]
            val = jnp.where(jnp.abs(hjj) > SMALLFLOAT, s / jnp.where(hjj != 0, hjj, 1.0), 0.0)
            return y.at[jj].set(jnp.where(act, val, 0.0))

        y = jax.lax.fori_loop(0, m, backsub, y)
        dx = prec(jnp.matmul(V[:m].T, y, precision=HIGHEST))
        x = x + dx

        res = jnp.abs(g[jnp.minimum(k_eff, m)])
        conv = res / normr0 < tol
        return (x, it + k_eff, res, conv)

    init = (x0, jnp.zeros((), jnp.int32), beta0, beta0 / normr0 < tol)
    x, it, res, conv = jax.lax.while_loop(outer_cond, outer_body, init)
    if return_iters:
        return x, conv, it
    return x, conv
