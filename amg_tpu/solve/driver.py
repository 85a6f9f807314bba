"""Outer AMG solve driver.

Replicates the reference's two-layer driver:

* ``SSS_solver_amg`` (amg/SSS_AMG.c:9-59): zero-rhs short circuit, sanity
  checks, setup + solve + total-time print.
* ``SSS_amg_solve`` (amg/Solve/SSS_SOLVE.c:4-87): cycle until
  ``||r||/||b|| < tol`` or ``max_it``, printing the per-iteration residual
  table (``SSS_print_itinfo``, amg/SSS_utils.c:104-133) with identical
  formatting.

Two execution modes:

* :meth:`AMGSolver.solve` — host loop, one jitted cycle+residual step per
  iteration, prints the residual table live (parity mode).
* :meth:`AMGSolver.solve_jit` — the whole iteration in one
  ``lax.while_loop`` under ``jit``: zero host<->device round trips, used for
  benchmarking and embedding in larger jitted programs.
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from ..params import AMGParams, SolveInfo, StopType, MAX_RESTART
from ..sparse import CSR
from ..hierarchy import setup, Hierarchy
from ..ops.spmv import spmv
from ..ops.blas import norm2
from .cycle import cycle


def print_itinfo(stop_type, it, relres, absres, factor, log=print):
    """Residual-table row, byte-compatible with the reference
    (``SSS_print_itinfo``, amg/SSS_utils.c:104-133)."""
    if it > 0:
        log("%6d | %13.6e   | %13.6e  | %10.4f" % (it, relres, absres, factor))
    else:
        log("-----------------------------------------------------------")
        if stop_type == StopType.REL_RES:
            log("It Num |   ||r||/||b||   |     ||r||      |  Conv. Factor")
        elif stop_type == StopType.REL_PRECRES:
            log("It Num | ||r||_B/||b||_B |    ||r||_B     |  Conv. Factor")
        else:
            log("It Num |   ||r||/||x||   |     ||r||      |  Conv. Factor")
        log("-----------------------------------------------------------")
        log("%6d | %13.6e   | %13.6e  |     -.-- " % (it, relres, absres))


def fcg_host_loop(pars, sumb, st, absres0, step, refresh, truenorm,
                 info, log=print):
    """Shared FCG host loop: batched residual fetches, periodic residual
    replacement, and a truth check on the exact stopping iterate before
    accepting convergence (reference false-convergence Check III,
    amg/Solve/SSS_cycle.cu:311-355).  Used by the single-chip and the
    shard_map solvers so the stopping semantics stay single-sourced.

    ``step(st) -> (st, absres)``; ``refresh(st) -> (st, absres)`` replaces
    the recursive residual with ``b - A x``; ``truenorm(x) -> absres``.
    Mutates ``info``; returns the device solution.
    """
    import jax.numpy as jnp
    import numpy as np

    check_every = 1 if pars.verbose else 4
    refresh_every = 10
    false_conv_left = 3
    pending: list = []  # (it, device x, device absres)
    xd = st[0]
    stop = False
    it = 0
    while it < pars.max_it:
        it += 1
        st, absres_d = step(st)
        if it % refresh_every == 0:
            st, absres_d = refresh(st)
        pending.append((it, st[0], absres_d))
        if len(pending) >= check_every or it == pars.max_it:
            batch = jnp.stack([r for _, _, r in pending])
            vals = np.asarray(batch)  # one sync for the whole batch
            converged = False
            for (it_i, x_i, _), absres in zip(pending, vals):
                absres = float(absres)
                relres = absres / sumb
                factor = absres / absres0 if absres0 > 0 else 0.0
                absres0 = absres
                if pars.verbose:
                    print_itinfo(pars.stop_type, it_i, relres, absres,
                                 factor, log=log)
                if not np.isfinite(absres):
                    if pars.verbose:
                        log("### WARNING: residual diverged "
                            f"(iteration {it_i}); stopping.")
                    stop = True
                    break
                info.ares, info.rres, info.nits = absres, relres, it_i
                info.residuals.append(absres)
                xd = x_i
                if relres < pars.tol:
                    converged = True
                    break
            pending = []
            if converged and not stop:
                # verify on the exact stopping iterate: the recursive
                # residual can flatter the truth by eps*kappa
                true_abs = float(truenorm(xd))
                true_rel = true_abs / sumb
                if true_rel < pars.tol or false_conv_left == 0:
                    info.ares, info.rres = true_abs, true_rel
                    stop = True
                else:
                    false_conv_left -= 1
                    # report the measured truth even if max_it exhausts
                    # before the next check (never exit on a flattering
                    # recursive value the truth check just disproved)
                    info.ares, info.rres = true_abs, true_rel
                    absres0 = true_abs
                    st, _ = refresh(st)
                    if pars.verbose:
                        log("### WARNING: false convergence "
                            f"(true relres {true_rel:.3e}); "
                            "residual replaced, continuing.")
        if stop:
            break
    return xd


class AMGSolver:
    """Setup once, solve many times."""

    def __init__(self, a: CSR, pars: AMGParams = AMGParams(), log=print,
                 host_hierarchy=None):
        if a.n_rows != a.n_cols:
            raise ValueError("AMG requires a square matrix")
        if a.nnz <= 0:
            raise ValueError("matrix has no nonzeros")
        self.a = a
        self.pars = pars
        self.log = log
        self.mg, self.host_hierarchy = setup(a, pars, log=log,
                                             hh=host_hierarchy)
        self.pad = self.mg.levels[0].pad
        self.dtype = jnp.dtype(pars.dtype)
        # level-0 similarity permutation (set when level 0 is RCM-ordered
        # for the WEll format): b/x0 are permuted on entry, the solution
        # un-permuted on exit; all internal residual norms are invariant
        hp = self.host_hierarchy.perms
        self._perm0 = hp[0] if hp is not None else None
        self._iperm0 = None
        if self._perm0 is not None:
            self._iperm0 = np.empty_like(self._perm0)
            self._iperm0[self._perm0] = np.arange(len(self._perm0))

        # the hierarchy is a jit ARGUMENT, not a closure capture: captured
        # arrays would be inlined into the HLO as literal constants (at 1M
        # rows that is a multi-hundred-MB program)
        def _step_fn(mg, x, b):
            x = cycle(mg, x, b, pars)
            r = b - spmv(mg.levels[0].a, x)
            return x, norm2(r)

        self._step_fn = jax.jit(_step_fn)
        self._step = lambda x, b: self._step_fn(self.mg, x, b)

        def _solve_full(mg, x, b, sumb):
            tol = pars.tol

            def cond(c):
                x, it, absres, hist = c
                return (it < pars.max_it) & (absres / sumb >= tol)

            def body(c):
                x, it, absres, hist = c
                x, absres = _step_fn(mg, x, b)
                hist = hist.at[it + 1].set(absres)
                return (x, it + 1, absres, hist)

            hist = jnp.full((pars.max_it + 1,), jnp.nan, self.dtype)
            hist = hist.at[0].set(sumb)
            init = (x, jnp.zeros((), jnp.int32), sumb, hist)
            x, nits, absres, hist = jax.lax.while_loop(cond, body, init)
            return x, nits, absres, hist

        self._solve_full_fn = jax.jit(_solve_full)
        self._solve_full = lambda x, b, sumb: self._solve_full_fn(
            self.mg, x, b, sumb
        )

        # -- mixed-precision defect correction --------------------------
        self.a0_hi = None
        if pars.refine and self.dtype != jnp.float64:
            from ..hierarchy import _pick_format
            from ..sparse import Dia, Dense, Ell, WEll

            # the internal (possibly level-0-permuted) operator — device
            # vectors live in that ordering, so the f64 operator must too
            a_int = self.host_hierarchy.a[0]
            fmt = _pick_format(a_int, pars)
            if fmt == "dia":
                self.a0_hi = Dia.from_csr(a_int, dtype=jnp.float64,
                                          pad_rows_to=self.pad)
            elif fmt == "dense":
                self.a0_hi = Dense.from_csr(a_int, dtype=jnp.float64,
                                            pad_rows_to=self.pad,
                                            pad_cols_to=self.pad)
            elif fmt == "well":
                # df64 split pack: hi + lo planes recombine to the f64
                # operator inside the apply
                self.a0_hi = WEll.from_csr_df64(a_int, pad_rows_to=self.pad,
                                                pad_cols_to=self.pad)
                # the df64 hi plane IS the f32 pack (same packer, same
                # slots): share it with the cycle's level-0 operator so
                # level 0 is resident ONCE, not twice (~1.6 GB at 10M
                # rows — the margin between fitting HBM and OOM there)
                import dataclasses as _dc

                w0 = self.mg.levels[0].a
                if (isinstance(w0, WEll)
                        and w0.vals.dtype == self.a0_hi.vals.dtype
                        and w0.vals.shape == self.a0_hi.vals.shape):
                    shared = WEll(self.a0_hi.vals, self.a0_hi.loc,
                                  self.a0_hi.base, w0.shape, w0.nnz,
                                  w0.pad_cols, None, w0.ring_plan)
                    self.mg = _dc.replace(
                        self.mg,
                        levels=(
                            _dc.replace(self.mg.levels[0], a=shared),
                        ) + self.mg.levels[1:])
            else:
                self.a0_hi = Ell.from_csr(a_int, dtype=jnp.float64,
                                          pad_rows_to=self.pad)

            k = max(pars.refine_inner_cycles, 1)

            def _refine_step(mg, a_hi, x_hi, b_hi):
                """One defect-correction iteration: f64 residual, k f32
                cycles on the scaled defect, f64 update."""
                r_hi = b_hi - spmv(a_hi, x_hi)[: b_hi.shape[0]]
                rn = norm2(r_hi)
                scale = jnp.where(rn > 0, rn, 1.0)
                r_lo = (r_hi / scale).astype(self.dtype)
                e = jnp.zeros_like(r_lo)
                for _ in range(k):
                    e = cycle(mg, e, r_lo, pars)
                x_hi = x_hi + e.astype(jnp.float64) * scale
                r2 = b_hi - spmv(a_hi, x_hi)[: b_hi.shape[0]]
                return x_hi, norm2(r2)

            self._refine_step_fn = jax.jit(_refine_step)
            self._refine_step = lambda x, b: self._refine_step_fn(
                self.mg, self.a0_hi, x, b
            )

        # -- Krylov acceleration (AMG-preconditioned flexible CG) -------
        if pars.accel in ("cg", "gmres"):
            from .krylov import fcg_init, fcg_step, fcg_refresh

            hi = self.a0_hi is not None
            self._accel_dtype = jnp.float64 if hi else self.dtype

            def _amul(mg, a_hi, v):
                a_op = a_hi if hi else mg.levels[0].a
                return spmv(a_op, v)[: v.shape[0]]

            def _prec(mg, r):
                """One AMG cycle in `dtype` on the (scaled) residual."""
                rn = norm2(r)
                scale = jnp.where(rn > 0, rn, 1.0)
                r_lo = (r / scale).astype(self.dtype)
                e = cycle(mg, jnp.zeros_like(r_lo), r_lo, pars)
                return e.astype(self._accel_dtype) * scale

            def _accel_init(mg, a_hi, x, b):
                st = fcg_init(lambda v: _amul(mg, a_hi, v),
                              lambda r: _prec(mg, r), b, x)
                return st, norm2(st[1])

            def _accel_step(mg, a_hi, st):
                return fcg_step(lambda v: _amul(mg, a_hi, v),
                                lambda r: _prec(mg, r), st)

            def _accel_refresh(mg, a_hi, st, b):
                return fcg_refresh(lambda v: _amul(mg, a_hi, v),
                                   lambda r: _prec(mg, r), b, st)

            def _true_resnorm(mg, a_hi, x, b):
                return norm2(b - _amul(mg, a_hi, x))

            self._accel_init_fn = jax.jit(_accel_init)
            self._accel_step_fn = jax.jit(_accel_step)
            self._accel_refresh_fn = jax.jit(_accel_refresh)
            self._true_resnorm_fn = jax.jit(_true_resnorm)

            if pars.accel == "gmres":
                from .krylov import gmres as _gmres

                def _accel_gmres(mg, a_hi, x, b):
                    return _gmres(
                        lambda v: _amul(mg, a_hi, v), b, x,
                        tol=pars.tol, maxit=pars.max_it,
                        restart=min(MAX_RESTART, pars.max_it),
                        M=lambda r: _prec(mg, r), return_iters=True,
                    )

                self._accel_gmres_fn = jax.jit(_accel_gmres)

    # ------------------------------------------------------------------

    def _pad_vec(self, v, dtype=None) -> jnp.ndarray:
        out = np.zeros(self.pad, dtype=dtype or self.dtype)
        vv = np.asarray(v, dtype=dtype or self.dtype)[: self.a.n_rows]
        if self._perm0 is not None:
            vv = vv[self._perm0]
        out[: self.a.n_rows] = vv
        return jnp.asarray(out)

    def _unpad_vec(self, xd) -> np.ndarray:
        """Device solution -> host vector in the caller's ordering."""
        x = np.asarray(xd[: self.a.n_rows])
        return x[self._iperm0] if self._iperm0 is not None else x

    def solve(self, b, x0=None) -> tuple[np.ndarray, SolveInfo]:
        """Host-loop solve with live residual table (reference parity)."""
        if self.pars.accel == "cg":
            return self.solve_pcg(b, x0)
        if self.pars.accel == "gmres":
            return self.solve_pgmres(b, x0)
        if self.a0_hi is not None:
            return self.solve_refined(b, x0)
        pars = self.pars
        n = self.a.n_rows
        bd = self._pad_vec(b)
        xd = self._pad_vec(x0 if x0 is not None else np.zeros(n))

        info = SolveInfo()
        sumb = float(norm2(bd))
        t0 = time.perf_counter()
        if pars.verbose:
            print_itinfo(pars.stop_type, 0, 1.0, sumb, 0.0, log=self.log)
        if sumb == 0.0:
            # reference zero-b short circuit (amg/Solve/SSS_SOLVE.c:41-46)
            return np.zeros(n), info

        absres0 = sumb
        info.residuals.append(sumb)
        # With the live table (verbose) every iteration syncs its residual
        # to the host.  Quiet mode keeps residuals on device and fetches
        # them in batches: a device->host fetch is a sync that stalls the
        # dispatch queue, dispatches are cheap.
        check_every = 1 if pars.verbose else 4
        mod_rel = pars.stop_type == StopType.MOD_REL_RES
        pending: list = []  # (it, device x, device absres)
        stop = False
        for it in range(1, pars.max_it + 1):
            xd, absres_d = self._step(xd, bd)
            pending.append((it, xd, absres_d))
            if len(pending) >= check_every or it == pars.max_it:
                batch = jnp.stack([r for _, _, r in pending])
                vals = np.asarray(batch)  # one sync for the whole batch
                xnorms = (
                    np.asarray(jnp.stack([norm2(xv) for _, xv, _ in pending]))
                    if mod_rel else None
                )
                for j, ((it_i, x_i, _), absres) in enumerate(
                        zip(pending, vals)):
                    absres = float(absres)
                    # stop_type semantics (reference SSS_STOP_TYPE,
                    # amg/Solve/SSS_cycle.cu:101-130): MOD_REL_RES divides
                    # by ||x||; REL_PRECRES with B=I equals REL_RES (the
                    # reference's preconditioner B is identity)
                    denom = (max(float(xnorms[j]), 1e-300) if mod_rel
                             else sumb)
                    relres = absres / denom
                    factor = absres / absres0
                    absres0 = absres
                    if pars.verbose:
                        print_itinfo(pars.stop_type, it_i, relres, absres,
                                     factor, log=self.log)
                    if not np.isfinite(absres):
                        # divergence guard: stop and keep the last finite
                        # iterate instead of iterating NaNs to max_it
                        if pars.verbose:
                            self.log("### WARNING: residual diverged "
                                     f"(iteration {it_i}); stopping.")
                        stop = True
                        break
                    info.ares, info.rres, info.nits = absres, relres, it_i
                    info.residuals.append(absres)
                    xd = x_i
                    if relres < pars.tol:
                        stop = True
                        break
                pending = []
            if stop:
                break
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        if pars.verbose:
            self.log(f"AMG solve time: {info.solve_seconds:g} s")
        return self._unpad_vec(xd), info

    def solve_refined(self, b, x0=None) -> tuple[np.ndarray, SolveInfo]:
        """Mixed-precision defect correction: k low-precision cycles per
        f64 residual update, iterated until the f64 relative residual
        meets ``tol``.  ``info.nits`` counts cycles for comparability with
        :meth:`solve`."""
        pars = self.pars
        n = self.a.n_rows
        k = max(pars.refine_inner_cycles, 1)

        b_hi = self._pad_vec(b, dtype=np.float64)
        x_hi = self._pad_vec(x0 if x0 is not None else np.zeros(n),
                             dtype=np.float64)

        info = SolveInfo()
        sumb = float(jnp.linalg.norm(b_hi))
        t0 = time.perf_counter()
        if pars.verbose:
            print_itinfo(pars.stop_type, 0, 1.0, sumb, 0.0, log=self.log)
        if sumb == 0.0:
            return np.zeros(n), info

        absres0 = sumb
        info.residuals.append(sumb)
        max_outer = max(pars.max_it // k, 1)
        # quiet mode dispatches outer steps speculatively and fetches their
        # residuals in pairs (same batching pattern as :meth:`solve`)
        check_every = 1 if pars.verbose else 2
        pending: list = []  # (outer, device x, device absres)
        stop = False
        for outer in range(1, max_outer + 1):
            x_hi, absres_d = self._refine_step(x_hi, b_hi)
            pending.append((outer, x_hi, absres_d))
            if len(pending) < check_every and outer != max_outer:
                continue
            vals = np.asarray(jnp.stack([r for _, _, r in pending]))
            for (outer_i, x_i, _), absres in zip(pending, vals):
                absres = float(absres)
                relres = absres / sumb
                factor = (absres / absres0) ** (1.0 / k)
                absres0 = absres
                if pars.verbose:
                    print_itinfo(pars.stop_type, outer_i * k, relres, absres,
                                 factor, log=self.log)
                if not np.isfinite(absres):
                    if pars.verbose:
                        self.log("### WARNING: residual diverged "
                                 f"(cycle {outer_i * k}); stopping.")
                    stop = True
                    break
                info.ares, info.rres, info.nits = absres, relres, outer_i * k
                info.residuals.append(absres)
                x_hi = x_i
                if relres < pars.tol:
                    stop = True
                    break
            pending = []
            if stop:
                break
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        if pars.verbose:
            self.log(f"AMG solve time: {info.solve_seconds:g} s")
        return self._unpad_vec(x_hi), info

    def solve_pcg(self, b, x0=None) -> tuple[np.ndarray, SolveInfo]:
        """AMG-preconditioned flexible CG (``pars.accel == "cg"``).

        Each iteration applies one AMG cycle (in ``pars.dtype``) as the
        preconditioner inside an FCG iteration running in f64 when
        ``pars.refine`` is set (mixed precision), else in ``pars.dtype``.
        ``info.nits`` counts FCG iterations (= cycles, comparable to
        :meth:`solve`).
        """
        pars = self.pars
        n = self.a.n_rows
        adt = self._accel_dtype

        bd = self._pad_vec(b, dtype=adt)
        xd = self._pad_vec(x0 if x0 is not None else np.zeros(n),
                           dtype=adt)

        info = SolveInfo()
        sumb = float(norm2(bd))
        t0 = time.perf_counter()
        if pars.verbose:
            print_itinfo(pars.stop_type, 0, 1.0, sumb, 0.0, log=self.log)
        if sumb == 0.0:
            return np.zeros(n), info

        st, absres_d = self._accel_init_fn(self.mg, self.a0_hi, xd, bd)
        absres0 = float(absres_d)
        info.residuals.append(absres0)
        # quiet mode batches residual fetches, same as :meth:`solve`
        xd = fcg_host_loop(
            pars, sumb, st, absres0,
            step=lambda s: self._accel_step_fn(self.mg, self.a0_hi, s),
            refresh=lambda s: self._accel_refresh_fn(
                self.mg, self.a0_hi, s, bd),
            truenorm=lambda x: self._true_resnorm_fn(
                self.mg, self.a0_hi, x, bd),
            info=info, log=self.log)
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        if pars.verbose:
            self.log(f"AMG solve time: {info.solve_seconds:g} s")
        return self._unpad_vec(xd), info

    def solve_pgmres(self, b, x0=None) -> tuple[np.ndarray, SolveInfo]:
        """AMG-right-preconditioned restarted GMRES (``pars.accel ==
        "gmres"``) — the Krylov wrap for nonsymmetric operators where CG's
        short recurrence does not apply.  Runs as one jitted program
        (``lax.while_loop`` over restarts)."""
        pars = self.pars
        n = self.a.n_rows
        adt = self._accel_dtype

        bd = self._pad_vec(b, dtype=adt)
        xd = self._pad_vec(x0 if x0 is not None else np.zeros(n),
                           dtype=adt)

        info = SolveInfo()
        sumb = float(norm2(bd))
        t0 = time.perf_counter()
        if sumb == 0.0:
            return np.zeros(n), info
        x, conv, nits = self._accel_gmres_fn(self.mg, self.a0_hi, xd, bd)
        r = bd - spmv((self.a0_hi if self.a0_hi is not None
                       else self.mg.levels[0].a), x)[: bd.shape[0]]
        absres = float(norm2(r))
        info.ares = absres
        info.rres = absres / sumb
        info.nits = int(nits)
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        if pars.verbose:
            self.log(f"AMG-GMRES: {info.nits} its, relres {info.rres:g}")
            self.log(f"AMG solve time: {info.solve_seconds:g} s")
        return self._unpad_vec(x), info

    def solve_batched(self, bs, x0s=None, tol=None):
        """Solve ``A X = B`` for many right-hand sides with ONE hierarchy.

        ``bs``: (n, k) columns.  The cycle is ``jax.vmap``-ed over the
        column axis, so every operator pass streams A once for all k
        systems (SpMV becomes SpMM) — the production serving mode the
        reference cannot express (its driver hard-wires one rhs,
        amg/SSS_main.c:141-145).  Iterates until EVERY column meets
        ``tol`` (default ``pars.tol``).  Returns ``(X, SolveInfo)`` with
        ``info.rres`` the worst column.
        """
        pars = self.pars
        tol = pars.tol if tol is None else tol
        n = self.a.n_rows
        bs = np.asarray(bs, dtype=self.dtype)
        if bs.ndim != 2:
            raise ValueError("bs must be (n, k)")
        k = bs.shape[1]
        if self._perm0 is not None:
            bs = bs[:n][self._perm0]
        bd = jnp.asarray(np.pad(bs[:n], ((0, self.pad - n), (0, 0))))
        x0s = np.zeros((n, k), dtype=self.dtype) if x0s is None \
            else np.asarray(x0s, dtype=self.dtype)
        if self._perm0 is not None:
            x0s = x0s[:n][self._perm0]
        xd = jnp.asarray(np.pad(x0s[:n], ((0, self.pad - n), (0, 0))))

        if getattr(self, "_batched_step_fn", None) is None or \
                self._batched_k != k:
            def _bstep(mg, x, b):
                def one(xc, bc):
                    xc = cycle(mg, xc, bc, pars)
                    r = bc - spmv(mg.levels[0].a, xc)
                    return xc, norm2(r)

                return jax.vmap(one, in_axes=(1, 1), out_axes=(1, 0))(x, b)

            self._batched_step_fn = jax.jit(_bstep)
            self._batched_k = k

        info = SolveInfo()
        sumb = np.maximum(
            np.linalg.norm(bs[:n], axis=0).astype(np.float64), 1e-300)
        t0 = time.perf_counter()
        nits = 0
        for it in range(1, pars.max_it + 1):
            xd, res_d = self._batched_step_fn(self.mg, xd, bd)
            res = np.asarray(res_d, dtype=np.float64)
            rel = res / sumb
            nits = it
            info.residuals.append(float(res.max()))
            if not np.all(np.isfinite(res)):
                if pars.verbose:
                    self.log("### WARNING: batched residual diverged; "
                             "stopping.")
                break
            if float(rel.max()) < tol:
                break
        info.nits = nits
        info.ares = float(res.max())
        info.rres = float(rel.max())
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        if pars.verbose:
            self.log(f"AMG batched solve: k={k}, {nits} its, worst "
                     f"relres {info.rres:g}, {info.solve_seconds:g} s")
        xs = np.asarray(xd[:n])
        if self._iperm0 is not None:
            xs = xs[self._iperm0]
        return xs, info

    def solve_jit(self, b, x0=None) -> tuple[np.ndarray, SolveInfo]:
        """Fully-jitted solve (no per-iteration host sync)."""
        n = self.a.n_rows
        bd = self._pad_vec(b)
        xd = self._pad_vec(x0 if x0 is not None else np.zeros(n))
        sumb = norm2(bd)
        t0 = time.perf_counter()
        x, nits, absres, hist = self._solve_full(xd, bd, sumb)
        x.block_until_ready()
        dt = time.perf_counter() - t0

        info = SolveInfo()
        info.nits = int(nits)
        info.ares = float(absres)
        info.rres = float(absres) / max(float(sumb), 1e-300)
        h = np.asarray(hist)
        info.residuals = [float(v) for v in h[~np.isnan(h)]]
        info.solve_seconds = dt
        info.setup_seconds = self.host_hierarchy.setup_seconds
        return self._unpad_vec(x), info


def solver_amg(a: CSR, x, b, pars: AMGParams = AMGParams(), log=print):
    """One-shot functional API mirroring ``SSS_solver_amg`` (amg/SSS_AMG.c:9).

    Returns ``(x, SolveInfo)``.
    """
    # zero-rhs short circuit before any setup (amg/SSS_AMG.c:23-30)
    sumb = float(np.linalg.norm(np.asarray(b, dtype=np.float64)))
    if sumb == 0.0:
        if pars.verbose:
            print_itinfo(StopType.REL_RES, 0, 0.0, sumb, 0.0, log=log)
        return np.zeros(a.n_rows), SolveInfo()
    t0 = time.perf_counter()
    solver = AMGSolver(a, pars, log=log)
    x, info = solver.solve(b, x0=x)
    if pars.verbose:
        log(f"AMG totally time: {time.perf_counter() - t0:g} s")
    return x, info
