"""Multi-chip distribution of the AMG solve phase.

The reference is strictly single-process/single-GPU (SURVEY.md section 0);
distribution is a capability this framework adds:

* **1-D row-block partition** of every level's padded ELL operator over a
  ``jax.sharding.Mesh`` axis ``'x'`` — the AMG analog of sequence/data
  parallelism (each chip owns a contiguous block of matrix rows and the
  matching slice of every vector).
* **GSPMD partitioning**: operators and vectors carry
  ``NamedSharding(P('x'))`` annotations; the *same* jitted cycle/Krylov code
  that runs on one chip runs on the mesh, with XLA inserting the collectives
  (all-gathers for the SpMV column gathers, psums for dot products).  This
  is the scaling-book recipe: pick a mesh, annotate shardings,
  let the compiler place communication.
* **Coarse-level replication**: levels whose nnz falls below
  ``pars.coarse_replicate_nnz`` are fully replicated so coarse corrections
  run without any communication — the coarse-grid-redistribution
  requirement in BASELINE.json.

The explicit halo-exchange alternative (ppermute rings overlapped with
the interior product) is :mod:`amg_tpu.parallel.spmd_cycle`.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hierarchy import Hierarchy, Level
from ..params import AMGParams
from ..sparse import Ell, Dia, Dense, BandedBlocks, WEll
from .multihost import fetch


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _row_sharding(mesh: Mesh, ndim: int, axis: str = "x") -> NamedSharding:
    spec = [None] * ndim
    spec[0] = axis
    return NamedSharding(mesh, P(*spec))


def _replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _pad_rows_multiple(e: Ell, multiple: int) -> Ell:
    """Re-pad an Ell's row dimension to a multiple (for even sharding)."""
    pr = e.padded_rows
    target = ((pr + multiple - 1) // multiple) * multiple
    if target == pr:
        return e
    extra = target - pr
    pad_cols = jnp.clip(
        jnp.arange(pr, target, dtype=jnp.int32)[:, None], 0, e.n_cols - 1
    )
    cols = jnp.concatenate(
        [e.cols, jnp.broadcast_to(pad_cols, (extra, e.width))], axis=0
    )
    vals = jnp.concatenate(
        [e.vals, jnp.zeros((extra, e.width), e.vals.dtype)], axis=0
    )
    return Ell(cols, vals, e.shape, e.nnz)


def _pad_vec_multiple(v: jnp.ndarray, multiple: int) -> jnp.ndarray:
    n = v.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return v
    return jnp.concatenate([v, jnp.zeros((target - n,) + v.shape[1:], v.dtype)])


def _pad_dia_multiple(d: Dia, multiple: int) -> Dia:
    pr = d.padded_rows
    target = ((pr + multiple - 1) // multiple) * multiple
    if target == pr:
        return d
    vals = jnp.pad(d.vals, ((0, 0), (0, target - pr)))
    return Dia(vals, d.offsets, d.shape, d.nnz)


def _shard_level(level: Level, mesh: Mesh, replicate: bool, ndev: int) -> Level:
    """Apply shardings to one level (row-dim arrays row-sharded).

    DIA operators shard their value planes on the row axis; the static
    shifted slices in the DIA SpMV become XLA-inserted halo exchanges
    (collective-permutes) between neighboring shards — exactly the
    row-partition + boundary-exchange design BASELINE.json asks for, with
    the compiler placing the communication.
    """
    if replicate:
        put = lambda arr: (
            jax.device_put(arr, _replicated(mesh)) if arr is not None else None
        )

        def put_mat(m):
            if m is None:
                return None
            if isinstance(m, Dia):
                return Dia(put(m.vals), m.offsets, m.shape, m.nnz)
            if isinstance(m, Dense):
                return Dense(put(m.vals), m.shape, m.nnz)
            if isinstance(m, BandedBlocks):
                return BandedBlocks(put(m.vals), m.nb, m.shape, m.nnz)
            if isinstance(m, WEll):
                return WEll(put(m.vals), put(m.loc), put(m.base),
                            m.shape, m.nnz, m.pad_cols, put(m.vals_lo),
                            m.ring_plan)
            return Ell(put(m.cols), put(m.vals), m.shape, m.nnz)

        return Level(
            a=put_mat(level.a),
            p=put_mat(level.p),
            r=put_mat(level.r),
            diag=put(level.diag),
            inv_diag=put(level.inv_diag),
            l1_inv=put(level.l1_inv),
            diag_mask=put(level.diag_mask),
            groups=put(level.groups),
            gid=put(level.gid),
            rho_dinv_a=put(level.rho_dinv_a),
            group_cf=level.group_cf,
            ranges=level.ranges,
            compact_idx=put(level.compact_idx),
            member_idx=put(level.member_idx),
        )

    def shard_rows(arr):
        if arr is None:
            return None
        arr = _pad_vec_multiple(arr, ndev)
        return jax.device_put(arr, _row_sharding(mesh, arr.ndim))

    def shard_mat(m):
        if m is None:
            return None
        if isinstance(m, Dia):
            d = _pad_dia_multiple(m, ndev)
            vals = jax.device_put(
                d.vals, NamedSharding(mesh, P(None, "x"))
            )
            return Dia(vals, d.offsets, d.shape, d.nnz)
        if isinstance(m, Dense):
            pr = m.padded_rows
            target = ((pr + ndev - 1) // ndev) * ndev
            vals = m.vals
            if target != pr:
                vals = jnp.pad(vals, ((0, target - pr), (0, 0)))
            vals = jax.device_put(vals, _row_sharding(mesh, 2))
            return Dense(vals, m.shape, m.nnz)
        if isinstance(m, BandedBlocks):
            # block rows (axis 0) row-sharded when they divide evenly (the
            # static shifted x slices in spmv_banded become XLA
            # collective-permutes between neighboring shards); growing nbr
            # would desync padded_rows from the level vectors, so odd
            # sizes replicate instead
            nbr = m.vals.shape[0]
            spec = P("x", None, None, None) if nbr % ndev == 0 else P()
            vals = jax.device_put(m.vals, NamedSharding(mesh, spec))
            return BandedBlocks(vals, m.nb, m.shape, m.nnz)
        if isinstance(m, WEll):
            # row groups (axis 0) sharded; the shard_map ring product
            # (parallel/halo.well_spmv_ring_local) is the consumer
            gspec = NamedSharding(mesh, P("x", None, None, None))
            bspec = NamedSharding(mesh, P("x", None))
            return WEll(
                jax.device_put(m.vals, gspec),
                jax.device_put(m.loc, gspec),
                jax.device_put(m.base, bspec),
                m.shape, m.nnz, m.pad_cols,
                (jax.device_put(m.vals_lo, gspec)
                 if m.vals_lo is not None else None),
                m.ring_plan,
            )
        e = _pad_rows_multiple(m, ndev)
        return Ell(
            jax.device_put(e.cols, _row_sharding(mesh, 2)),
            jax.device_put(e.vals, _row_sharding(mesh, 2)),
            e.shape,
            e.nnz,
        )

    return Level(
        a=shard_mat(level.a),
        # P has fine rows (sharded); its column gathers read the coarse
        # vector (possibly replicated) — XLA handles the transition.
        p=shard_mat(level.p),
        r=shard_mat(level.r),
        diag=shard_rows(level.diag),
        inv_diag=shard_rows(level.inv_diag),
        l1_inv=shard_rows(level.l1_inv),
        diag_mask=shard_rows(level.diag_mask),
        gid=shard_rows(level.gid),
        # groups index global rows; keep them replicated
        groups=(
            jax.device_put(level.groups, _replicated(mesh))
            if level.groups is not None
            else None
        ),
        rho_dinv_a=jax.device_put(level.rho_dinv_a, _replicated(mesh)),
        group_cf=level.group_cf,
        ranges=level.ranges,
        compact_idx=(
            jax.device_put(level.compact_idx, _replicated(mesh))
            if level.compact_idx is not None
            else None
        ),
        member_idx=(
            jax.device_put(level.member_idx, _replicated(mesh))
            if level.member_idx is not None
            else None
        ),
    )


def shard_hierarchy(
    mg: Hierarchy, mesh: Mesh, pars: AMGParams | None = None,
    replicate_from_level: int | None = None,
) -> Hierarchy:
    """Annotate a device hierarchy with mesh shardings.

    Fine levels are row-sharded; levels below the replication threshold are
    replicated on every chip (coarse-grid replication).
    ``replicate_from_level`` overrides the nnz threshold with an explicit
    level cut (used by the shard_map cycle: sharded embedded levels,
    replicated compact tail).
    """
    thresh = pars.coarse_replicate_nnz if pars is not None else 65536
    ndev = int(np.prod(list(mesh.shape.values())))
    levels = []
    for l, lvl in enumerate(mg.levels):
        if replicate_from_level is not None:
            replicate = l >= replicate_from_level
        else:
            replicate = lvl.a.nnz <= thresh or lvl.pad < 8 * ndev
        levels.append(_shard_level(lvl, mesh, replicate, ndev))
    coarse_inv = jax.device_put(mg.coarse_inv, _replicated(mesh))
    return Hierarchy(levels=tuple(levels), coarse_inv=coarse_inv)


def shard_vector(v, mesh: Mesh, pad_to: int | None = None):
    """Row-shard a vector (padding to the mesh size multiple)."""
    ndev = int(np.prod(list(mesh.shape.values())))
    v = jnp.asarray(v)
    if pad_to is not None and v.shape[0] < pad_to:
        v = _pad_vec_multiple(v, pad_to)
    v = _pad_vec_multiple(v, ndev)
    return jax.device_put(v, _row_sharding(mesh, v.ndim))


class DistAMGSolver:
    """Multi-chip AMG solver: setup on host, sharded jitted solve.

    Same numerics as :class:`~amg_tpu.solve.driver.AMGSolver`; the hierarchy
    and all vectors carry mesh shardings so every SpMV/dot in the cycle runs
    SPMD over the mesh.
    """

    def __init__(self, a, pars: AMGParams = AMGParams(), mesh: Mesh | None = None,
                 log=print):
        from ..hierarchy import setup

        self.mesh = mesh if mesh is not None else make_mesh()
        self.ndev = int(np.prod(list(self.mesh.shape.values())))
        self.a = a
        self.pars = pars
        mg, hh = setup(a, pars, log=log)
        self.host_hierarchy = hh
        self.mg = shard_hierarchy(mg, self.mesh, pars)
        self.dtype = jnp.dtype(pars.dtype)
        # level-0 padded size after sharding
        self.pad = self.mg.levels[0].a.padded_rows

        from ..solve.cycle import cycle
        from ..ops.spmv import spmv
        from ..ops.blas import norm2

        # hierarchy passed as a jit argument (closure capture would inline
        # every operator into the HLO as a literal constant)
        def _step_fn(mg, x, b):
            x = cycle(mg, x, b, pars)
            r = b - spmv(mg.levels[0].a, x)
            return x, norm2(r)

        self._step_fn = jax.jit(_step_fn)
        self._step = lambda x, b: self._step_fn(self.mg, x, b)

        # mixed-precision defect correction (sharded): f64 level-0 operator
        # row-sharded like the rest of the hierarchy
        self.a0_hi = None
        if pars.refine and self.dtype != jnp.float64:
            from ..hierarchy import _pick_format
            from ..sparse import CSR as _CSR

            fmt = _pick_format(a, pars)
            if fmt == "dia":
                hi = Dia.from_csr(a, dtype=jnp.float64, pad_rows_to=self.pad)
                hi = _pad_dia_multiple(hi, self.ndev)
                vals = jax.device_put(hi.vals,
                                      NamedSharding(self.mesh, P(None, "x")))
                self.a0_hi = Dia(vals, hi.offsets, hi.shape, hi.nnz)
            else:
                hi = Ell.from_csr(a, dtype=jnp.float64, pad_rows_to=self.pad)
                hi = _pad_rows_multiple(hi, self.ndev)
                self.a0_hi = Ell(
                    jax.device_put(hi.cols, _row_sharding(self.mesh, 2)),
                    jax.device_put(hi.vals, _row_sharding(self.mesh, 2)),
                    hi.shape, hi.nnz,
                )

            k = max(pars.refine_inner_cycles, 1)

            def _refine_fn(mg, a_hi, x_hi, b_hi):
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

            self._refine_fn = jax.jit(_refine_fn)
            self._refine_step = lambda x, b: self._refine_fn(
                self.mg, self.a0_hi, x, b
            )

    def _pad_vec(self, v):
        out = np.zeros(self.pad, dtype=self.dtype)
        out[: self.a.n_rows] = np.asarray(v, dtype=self.dtype)[: self.a.n_rows]
        return shard_vector(out, self.mesh)

    def solve_refined(self, b, x0=None):
        """Sharded mixed-precision defect correction (see
        AMGSolver.solve_refined)."""
        from ..params import SolveInfo
        from ..solve.driver import print_itinfo
        import time

        pars = self.pars
        n = self.a.n_rows
        k = max(pars.refine_inner_cycles, 1)
        b_hi = np.zeros(self.pad)
        b_hi[:n] = np.asarray(b, dtype=np.float64)[:n]
        x_hi = np.zeros(self.pad)
        if x0 is not None:
            x_hi[:n] = np.asarray(x0, dtype=np.float64)[:n]
        b_hi = shard_vector(b_hi, self.mesh)
        x_hi = shard_vector(x_hi, self.mesh)

        info = SolveInfo()
        sumb = float(jnp.linalg.norm(b_hi))
        if sumb == 0.0:
            return np.zeros(n), info
        absres0 = sumb
        t0 = time.perf_counter()
        if pars.verbose:
            print_itinfo(pars.stop_type, 0, 1.0, sumb, 0.0)
        info.residuals.append(sumb)
        for outer in range(1, max(pars.max_it // k, 1) + 1):
            x_hi, absres_d = self._refine_step(x_hi, b_hi)
            absres = float(absres_d)
            relres = absres / sumb
            factor = (absres / absres0) ** (1.0 / k)
            absres0 = absres
            if pars.verbose:
                print_itinfo(pars.stop_type, outer * k, relres, absres,
                             factor)
            info.ares, info.rres, info.nits = absres, relres, outer * k
            info.residuals.append(absres)
            if relres < pars.tol:
                break
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        return fetch(x_hi)[:n], info

    def solve(self, b, x0=None):
        from ..params import SolveInfo
        from ..solve.driver import print_itinfo
        import time

        if self.a0_hi is not None:
            return self.solve_refined(b, x0)

        pars = self.pars
        n = self.a.n_rows
        bd = self._pad_vec(b)
        xd = self._pad_vec(x0 if x0 is not None else np.zeros(n))

        info = SolveInfo()
        sumb = float(jnp.linalg.norm(bd))
        if sumb == 0.0:
            return np.zeros(n), info
        absres0 = sumb
        t0 = time.perf_counter()
        if pars.verbose:
            print_itinfo(pars.stop_type, 0, 1.0, sumb, 0.0)
        for it in range(1, pars.max_it + 1):
            xd, absres_d = self._step(xd, bd)
            absres = float(absres_d)
            relres = absres / sumb
            factor = absres / absres0
            absres0 = absres
            if pars.verbose:
                print_itinfo(pars.stop_type, it, relres, absres, factor)
            info.ares, info.rres, info.nits = absres, relres, it
            info.residuals.append(absres)
            if relres < pars.tol:
                break
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        return fetch(xd)[:n], info
