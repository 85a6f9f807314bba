"""Hand-placed SPMD V-cycle under ``shard_map``.

The GSPMD path (parallel/dist.py) annotates shardings and lets XLA place
the collectives.  This module is the explicit alternative for
fine-grid-embedded hierarchies, where every hot operator is a DIA
stencil over the shared fine-grid index space:

* levels ``0..E`` are **row-sharded**: vectors split into contiguous
  blocks, operators split their value planes (``P(None, 'x')``); every
  operator application is the ring halo-exchange product of
  :mod:`amg_tpu.parallel.halo` (two neighbor ``ppermute`` s + local
  compute);
* the embedded->compact boundary compacts the residual with a local
  clipped gather + ``psum`` (the compact vector is small and becomes
  replicated);
* compact levels ``> E`` are **replicated**: every shard runs the
  identical small-coarse correction (the standard coarse-grid
  redundancy trade — no communication at depth);
* dots and norms ``psum`` over the mesh axis.

This is the scaling-book "place the collectives yourself" recipe: the
halo exchange and its overlap with interior compute are explicit rather
than inferred.  No reference equivalent (the reference is
single-address-space; SURVEY.md section 5 "long-context analog").
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..hierarchy import Hierarchy, Level
from ..params import AMGParams, SmootherType
from ..sparse import Dia, Ell, Dense, BandedBlocks, WEll
from ..ops.blas import norm2
from .halo import (dia_spmv_ring_local, well_spmv_ring_local,
                   banded_spmv_ring_local, well_spmv_local_full,
                   _well_apply)


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------


def _mat_specs(m, row_sharded: bool, axis: str):
    """Spec pytree with the same structure as matrix container ``m``."""
    if m is None:
        return None
    if isinstance(m, Dia):
        spec = P(None, axis) if row_sharded else P()
        return Dia(spec, m.offsets, m.shape, m.nnz)
    if isinstance(m, Ell):
        s = P(axis) if row_sharded else P()
        return Ell(s, s, m.shape, m.nnz)
    if isinstance(m, Dense):
        return Dense(P(axis) if row_sharded else P(), m.shape, m.nnz)
    if isinstance(m, BandedBlocks):
        spec = P(axis, None, None, None) if row_sharded else P()
        return BandedBlocks(spec, m.nb, m.shape, m.nnz)
    if isinstance(m, WEll):
        g = P(axis, None, None, None) if row_sharded else P()
        b = P(axis, None) if row_sharded else P()
        return WEll(g, g, b, m.shape, m.nnz, m.pad_cols,
                    None if m.vals_lo is None else g, m.ring_plan)
    raise TypeError(type(m))


def _level_specs(level: Level, sharded: bool, axis: str) -> Level:
    V = P(axis) if sharded else P()
    R = P()

    def vec(x, spec):
        return None if x is None else spec

    return Level(
        a=_mat_specs(level.a, sharded, axis),
        p=_mat_specs(level.p, sharded, axis),
        r=_mat_specs(level.r, sharded, axis),
        diag=vec(level.diag, V),
        inv_diag=vec(level.inv_diag, V),
        l1_inv=vec(level.l1_inv, V),
        diag_mask=vec(level.diag_mask, R),
        groups=vec(level.groups, R),
        gid=vec(level.gid, V),
        rho_dinv_a=R,
        group_cf=level.group_cf,
        ranges=level.ranges,
        compact_idx=vec(level.compact_idx, R),
        member_idx=vec(level.member_idx, R),
    )


def hierarchy_specs(mg: Hierarchy, n_embedded: int, axis: str = "x"):
    """Partition-spec pytree for a hierarchy: levels ``0..n_embedded``
    row-sharded, deeper (compact) levels replicated."""
    levels = tuple(
        _level_specs(lvl, l <= n_embedded, axis)
        for l, lvl in enumerate(mg.levels)
    )
    return Hierarchy(levels=levels, coarse_inv=P())


def num_embedded(mg: Hierarchy) -> int:
    """Deepest fine-grid-embedded level: the one carrying the boundary
    (compact_idx / member_idx); 0 when the hierarchy is fully compact."""
    for l, lvl in enumerate(mg.levels):
        if lvl.compact_idx is not None or lvl.member_idx is not None:
            return l
    return 0


# ---------------------------------------------------------------------------
# Local (per-shard) building blocks — call INSIDE shard_map
# ---------------------------------------------------------------------------


def _ring_spmv(a, x_local, axis: str, n_shards: int):
    """Per-shard ring halo-exchange product, dispatched on format — the
    multi-chip counterparts of every single-chip fast format (VERDICT r4
    item 4: the fast formats must not switch off on a pod)."""
    if isinstance(a, Dia):
        return dia_spmv_ring_local(a.offsets, n_shards, axis, a.vals,
                                   x_local)
    if isinstance(a, WEll):
        if a.ring_plan is None:
            raise ValueError("WEll operator packed without a ring plan "
                             "(set pars.dist_devices at setup)")
        lo128, hi128 = a.ring_plan
        return well_spmv_ring_local(a, x_local, axis, n_shards,
                                    lo128, hi128)
    if isinstance(a, BandedBlocks):
        return banded_spmv_ring_local(a.nb, n_shards, axis, a.vals,
                                      x_local)
    raise TypeError(f"no ring product for {type(a).__name__}")


def _chebyshev_local(level, x, b, degree, axis, n_shards):
    """Chebyshev smoothing with ring SpMVs (same math as
    solve/smoothers.py::_chebyshev)."""
    amul = lambda v: _ring_spmv(level.a, v, axis, n_shards)
    rho = level.rho_dinv_a
    theta = 0.5 * (rho + rho / 4.0)
    delta = 0.5 * (rho - rho / 4.0)
    sigma = theta / delta
    rho_old = 1.0 / sigma

    r = level.inv_diag * (b - amul(x))
    d = r / theta
    x = x + d
    for _ in range(max(degree - 1, 0)):
        rho_new = 1.0 / (2.0 * sigma - rho_old)
        r = level.inv_diag * (b - amul(x))
        d = rho_new * rho_old * d + 2.0 * rho_new / delta * r
        x = x + d
        rho_old = rho_new
    return x


def _gs_sweep_local(level, x, b, order, axis, n_shards, relax=None):
    """One masked GS sweep over color groups with ring SpMVs (the
    shard_map counterpart of solve/smoothers.py::gs_sweep)."""
    for g in order:
        ax = _ring_spmv(level.a, x, axis, n_shards)
        t = (b - ax + level.diag * x) * level.inv_diag
        if relax is not None:
            t = (1.0 - relax) * x + relax * t
        upd = (level.gid == g) & (level.inv_diag != 0)
        x = jnp.where(upd, t, x)
    return x


def _smooth_local(level, x, b, pars, nsweeps, pre, axis, n_shards):
    """Distributed smoother dispatch — the full SmootherType surface of
    solve/smoothers.py::smooth, with every operator application a ring
    halo-exchange product and every dot a psum."""
    from ..solve.smoothers import _order, _cg_smooth

    sm = pars.smoother
    if sm in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        return _chebyshev_local(level, x, b, pars.poly_deg, axis, n_shards)
    if sm == SmootherType.CG:
        return _cg_smooth(level, x, b, nsweeps, axis_name=axis,
                          spmv_fn=lambda v: _ring_spmv(level.a, v, axis,
                                                       n_shards))
    if sm in (SmootherType.JACOBI, SmootherType.WJACOBI):
        w = 1.0 if sm == SmootherType.JACOBI else pars.relax
        for _ in range(nsweeps):
            x = x + w * level.inv_diag * (
                b - _ring_spmv(level.a, x, axis, n_shards))
        return x
    if sm == SmootherType.L1DIAG:
        for _ in range(nsweeps):
            x = x + level.l1_inv * (
                b - _ring_spmv(level.a, x, axis, n_shards))
        return x

    relax = pars.relax
    sweep = lambda x, order, rlx=None: _gs_sweep_local(
        level, x, b, order, axis, n_shards, relax=rlx)
    fwd = lambda: _order(level, True, 0, True)
    bwd = lambda: _order(level, False, 0, False)
    for _ in range(nsweeps):
        if sm == SmootherType.GS:
            x = sweep(x, _order(level, pre, pars.cf_order, pre))
        elif sm == SmootherType.SOR:
            x = sweep(x, _order(level, pre, pars.cf_order, pre), relax)
        elif sm == SmootherType.SGS:
            x = sweep(x, fwd())
            x = sweep(x, bwd())
        elif sm == SmootherType.SSOR:
            x = sweep(x, fwd(), relax)
            x = sweep(x, bwd(), relax)
        elif sm == SmootherType.GSOR:
            x = sweep(x, _order(level, pre, pars.cf_order, pre))
            x = sweep(x, _order(level, pre, pars.cf_order, pre), relax)
        elif sm == SmootherType.SGSOR:
            x = sweep(x, fwd())
            x = sweep(x, bwd())
            x = sweep(x, fwd(), relax)
            x = sweep(x, bwd(), relax)
        else:
            raise ValueError(f"unsupported smoother {sm}")
    return x


def _cycle_local(mg, l, x, b, pars, ctol, E, axis, n_shards, m_local):
    """One V/W-cycle on the sharded embedded levels; replicated compact
    recursion below the boundary."""
    from ..solve.cycle import _cycle_level, coarsest_solve

    nl = mg.num_levels
    level = mg.levels[l]
    repeats = 1 if l == 0 else max(pars.cycle_type, 1)
    pars_l = pars if (l == 0 or pars.coarse_smoother is None) \
        else pars.replace(smoother=pars.coarse_smoother)
    if pars.poly_deg_schedule is not None:
        sched = pars.poly_deg_schedule
        pars_l = pars_l.replace(poly_deg=sched[min(l, len(sched) - 1)])

    for _ in range(repeats):
        x = _smooth_local(level, x, b, pars_l, pars.pre_iter, True,
                          axis, n_shards)
        r = b - _ring_spmv(level.a, x, axis, n_shards)
        if l == E:
            # boundary: compact the residual.  member positions are
            # global; each shard contributes the entries it owns, psum
            # replicates the (small) compact vector everywhere.
            if level.member_idx is not None:
                ridx = level.member_idx
                rc_full = r  # embedded residual (local block)
            else:
                # embedded-P/R boundary: apply embedded R first, then
                # compact via compact_idx
                rc_full = _ring_spmv(level.r, r, axis, n_shards)
                ridx = level.compact_idx
            start = jax.lax.axis_index(axis) * m_local
            loc = ridx.astype(jnp.int32) - start
            inrange = (loc >= 0) & (loc < m_local)
            gathered = rc_full[jnp.clip(loc, 0, m_local - 1)]
            rc = jax.lax.psum(
                jnp.where(inrange, gathered, 0.0), axis)
            if level.member_idx is not None:
                nE = level.p.n_rows
                rc = jnp.where(jnp.arange(rc.shape[0]) < nE, rc, 0.0)
                bc = _compact_spmv(level.r, rc)
                nn = mg.levels[l + 1].n
                bc = jnp.where(jnp.arange(bc.shape[0]) < nn, bc, 0.0)
            else:
                nn = mg.levels[l + 1].n
                bc = jnp.where(jnp.arange(rc.shape[0]) < nn, rc, 0.0)
            xc = jnp.zeros_like(bc)
            # replicated compact correction (identical on every shard)
            xc = _cycle_level(mg, l + 1, xc, bc, pars, ctol)
            # prolong back: compact -> embedded scatter into local block
            if level.member_idx is not None:
                xe_c = _compact_spmv(level.p, xc)
                src = xe_c
                sidx = level.member_idx
            else:
                # scatter compact values to embedded positions, then
                # apply embedded P
                sidx = level.compact_idx
                src = xc
            loc_s = sidx.astype(jnp.int32) - start
            in_s = (loc_s >= 0) & (loc_s < m_local)
            contrib = jnp.zeros_like(x).at[
                jnp.where(in_s, loc_s, m_local)
            ].add(jnp.where(in_s, src.astype(x.dtype), 0.0), mode="drop")
            if level.member_idx is not None:
                x = x + contrib
            else:
                x = x + _ring_spmv(level.p, contrib, axis, n_shards)
        else:
            bc = _ring_spmv(level.r, r, axis, n_shards)
            xc = jnp.zeros_like(bc)
            xc = _cycle_local(mg, l + 1, xc, bc, pars, ctol, E, axis,
                              n_shards, m_local)
            x = x + _ring_spmv(level.p, xc, axis, n_shards)
        x = _smooth_local(level, x, b, pars_l, pars.post_iter, False,
                          axis, n_shards)
    return x


def _compact_spmv(a, v):
    from ..ops.spmv import spmv

    return spmv(a, v)


def cycle_spmd(mg, x, b, pars, E, axis, n_shards, m_local):
    """One cycle on the sharded level-0 block (inside shard_map)."""
    ctol = min(pars.ctol, pars.tol * 0.1) if pars.ctol > pars.tol \
        else pars.ctol
    if E == 0:
        raise ValueError("shard_map cycle requires an embedded hierarchy "
                         "(E >= 1); use the GSPMD DistAMGSolver otherwise")
    return _cycle_local(mg, 0, x, b, pars, ctol, E, axis, n_shards, m_local)


# ---------------------------------------------------------------------------
# General sharded cycle (round 5): row-sharded WEll / BandedBlocks / Dia
# levels with real P/R transfer operators — the multi-chip path for
# UNSTRUCTURED hierarchies (no fine-grid embedding).  Levels 0..Es are
# sharded; the boundary all_gathers the (small) first compact vector and
# the tail runs replicated exactly like the embedded mode.
# ---------------------------------------------------------------------------


def _transfer_sharded(t, pad_out: int, ndev: int) -> bool:
    """Static test: is this (local view of a) transfer operator sharded
    over its output rows?  Inside shard_map local shapes are static, so
    comparing the local row count against the level pad decides."""
    if not isinstance(t, WEll):
        return False
    return t.padded_rows * ndev == pad_out


def _cycle_general(mg, l, x, b, pars, ctol, Es, axis, ndev):
    """V/W-cycle on the general sharded prefix (inside shard_map)."""
    from ..solve.cycle import _cycle_level
    from ..ops.spmv import spmv as _spmv

    nl = mg.num_levels
    level = mg.levels[l]
    repeats = 1 if l == 0 else max(pars.cycle_type, 1)
    pars_l = pars if (l == 0 or pars.coarse_smoother is None) \
        else pars.replace(smoother=pars.coarse_smoother)
    if pars.poly_deg_schedule is not None:
        sched = pars.poly_deg_schedule
        pars_l = pars_l.replace(poly_deg=sched[min(l, len(sched) - 1)])

    for _ in range(repeats):
        x = _smooth_local(level, x, b, pars_l, pars.pre_iter, True,
                          axis, ndev)
        r = b - _ring_spmv(level.a, x, axis, ndev)
        if l == Es:
            # boundary: coarse vector becomes replicated.  Fast path:
            # ring-apply the groups-sharded R, then one all_gather of
            # the SMALL coarse vector.  Fallback (non-WEll transfers):
            # all_gather the fine residual, apply the replicated R.
            nn = mg.levels[l + 1].n
            pad_c = mg.levels[l + 1].pad
            if _transfer_sharded(level.r, pad_c, ndev):
                bc_loc = _ring_spmv(level.r, r, axis, ndev)
                bc = jax.lax.all_gather(bc_loc, axis, tiled=True)
            else:
                r_full = jax.lax.all_gather(r, axis, tiled=True)
                bc = _spmv(level.r, r_full)
            bc = bc[:pad_c]
            bc = jnp.where(jnp.arange(bc.shape[0]) < nn, bc,
                           jnp.zeros((), bc.dtype))
            xc = jnp.zeros_like(bc)
            xc = _cycle_level(mg, l + 1, xc, bc, pars, ctol)
            m_l = x.shape[0]
            if _transfer_sharded(level.p, m_l * ndev, ndev):
                x = x + well_spmv_local_full(level.p, xc).astype(x.dtype)
            else:
                xe = _spmv(level.p, xc)
                start = (jax.lax.axis_index(axis).astype(jnp.int32)
                         * jnp.int32(m_l))
                x = x + jax.lax.dynamic_slice(
                    xe, (start,), (m_l,)).astype(x.dtype)
        else:
            bc = _ring_spmv(level.r, r, axis, ndev)
            xc = jnp.zeros_like(bc)
            xc = _cycle_general(mg, l + 1, xc, bc, pars, ctol, Es, axis,
                                ndev)
            x = x + _ring_spmv(level.p, xc, axis, ndev)
        x = _smooth_local(level, x, b, pars_l, pars.post_iter, False,
                          axis, ndev)
    return x


def cycle_general(mg, x, b, pars, Es, axis, ndev):
    ctol = min(pars.ctol, pars.tol * 0.1) if pars.ctol > pars.tol \
        else pars.ctol
    return _cycle_general(mg, 0, x, b, pars, ctol, Es, axis, ndev)


def _ring_capable(m, ndev: int) -> bool:
    """Can this operator be row-sharded for the ring product?"""
    if isinstance(m, Dia):
        rows = (m.vals.shape[1] * 128 if m.vals.ndim == 3
                else m.vals.shape[1])
        return rows % ndev == 0
    if isinstance(m, WEll):
        return m.ring_plan is not None
    if isinstance(m, BandedBlocks):
        return m.vals.shape[0] % ndev == 0
    return False


def general_shard_depth(mg, ndev: int) -> int:
    """Longest sharded prefix 0..Es for the general cycle, or -1 when
    even level 0 cannot shard.  Interior levels need ring-capable
    A/P/R; the boundary level needs a ring-capable A (its transfers may
    fall back to the all_gather boundary)."""
    nl = mg.num_levels
    if nl < 2 or not _ring_capable(mg.levels[0].a, ndev):
        return -1
    Es = 0
    while Es < nl - 2:
        lvl = mg.levels[Es]
        if (isinstance(lvl.p, WEll) and lvl.p.ring_plan is not None
                and isinstance(lvl.r, WEll)
                and lvl.r.ring_plan is not None
                and _ring_capable(mg.levels[Es + 1].a, ndev)):
            Es += 1
        else:
            break
    return Es


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


class SpmdAMGSolver:
    """Multi-chip AMG with the hand-placed shard_map cycle.

    Setup runs on the host exactly as for :class:`AMGSolver`; the device
    hierarchy is placed with row shardings on the embedded levels and
    replication below, and each solve iteration is ONE shard_map program:
    ring halo exchanges on the embedded levels, psum reductions, and
    redundant replicated coarse corrections.
    """

    def __init__(self, a, pars: AMGParams = AMGParams(),
                 mesh: Mesh | None = None, log=print):
        from ..hierarchy import setup
        from .dist import make_mesh, shard_hierarchy, shard_vector

        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = self.mesh.axis_names[0]
        self.ndev = int(np.prod(list(self.mesh.shape.values())))
        self.a = a
        # BandedBlocks levels sit below the embedded boundary (l > E), so
        # they run in the replicated compact tail — same single-chip code
        if pars.embed_levels < 0:
            # this solver IS the embedded-hierarchy distribution path:
            # resolve auto embedding to "on" on every backend (the CPU
            # auto default is 0, which would make setup un-shardable)
            pars = pars.replace(embed_levels=8)
        if pars.dist_devices != self.ndev:
            # ring-aware packing: D-divisible pads, WEll/BandedBlocks kept
            # on under "auto", WEll ring halo plans precomputed
            pars = pars.replace(dist_devices=self.ndev)
        self.pars = pars
        mg, hh = setup(a, pars, log=log)
        self.host_hierarchy = hh
        # level-0 permutation (RCM for WEll level 0): b/x0 map in on
        # entry, x maps back on exit (same surface as AMGSolver)
        hp = getattr(hh, "perms", None)
        self._perm0 = hp[0] if hp is not None else None
        self._iperm0 = None
        if self._perm0 is not None:
            self._iperm0 = np.empty_like(self._perm0)
            self._iperm0[self._perm0] = np.arange(len(self._perm0))
        self.E = num_embedded(mg)
        self.Es = -1
        if self.E == 0:
            # no fine-grid embedding (unstructured / general matrix):
            # try the general sharded cycle over ring-capable levels
            self.Es = general_shard_depth(mg, self.ndev)
            if self.Es < 0:
                raise ValueError(
                    "SpmdAMGSolver requires either a fine-grid-embedded "
                    "hierarchy or a ring-capable (WEll/Dia/BandedBlocks) "
                    "level 0; use DistAMGSolver instead")
            self._init_general(mg, pars)
            return
        self.pad = mg.levels[0].pad
        if self.pad % self.ndev != 0:
            raise ValueError(
                f"padded rows {self.pad} not divisible by mesh size "
                f"{self.ndev}")
        self.m_local = self.pad // self.ndev
        # bands wider than a shard block take multi-hop halos (halo.py);
        # no feasibility restriction beyond the mesh extent
        # place the arrays: row-shard embedded levels, replicate the rest
        self.mg = shard_hierarchy(mg, self.mesh, pars,
                                  replicate_from_level=self.E + 1)
        self.dtype = jnp.dtype(pars.dtype)

        from jax import shard_map

        specs = hierarchy_specs(self.mg, self.E, self.axis)
        axis, ndev, m_local, E = self.axis, self.ndev, self.m_local, self.E

        def _step_local(mg_l, x_l, b_l):
            x_l = cycle_spmd(mg_l, x_l, b_l, pars, E, axis, ndev, m_local)
            r_l = b_l - dia_spmv_ring_local(
                mg_l.levels[0].a.offsets, ndev, axis,
                mg_l.levels[0].a.vals, x_l)
            return x_l, norm2(r_l, axis)

        self._step_fn = jax.jit(
            shard_map(
                _step_local,
                mesh=self.mesh,
                in_specs=(specs, P(self.axis), P(self.axis)),
                out_specs=(P(self.axis), P()),
            )
        )
        self._shard_vector = lambda v: shard_vector(v, self.mesh)

        # -- FCG wrap (pars.accel == "cg") ------------------------------
        # The sparsified distributed cycle is a good preconditioner but
        # not a reliable contraction at 10M-row scale (bench.py); the
        # flexible-CG outer iteration (psum dots) is what makes the
        # multi-chip solve robust.  Outer precision: f64 against the
        # exact row-sharded Dia level-0 operator when pars.refine.
        self.a0_hi = None
        if pars.accel == "cg":
            from jax.sharding import NamedSharding
            from ..solve.krylov import fcg_init, fcg_step
            from ..sparse import Dia as _Dia

            hi = pars.refine and self.dtype != jnp.float64
            self._accel_dtype = jnp.float64 if hi else self.dtype
            if hi:
                a_hi = _Dia.from_csr(a, dtype=jnp.float64,
                                     pad_rows_to=self.pad)
                self.a0_hi = _Dia(
                    jax.device_put(
                        a_hi.vals,
                        NamedSharding(self.mesh, P(None, self.axis))),
                    a_hi.offsets, a_hi.shape, a_hi.nnz)
            hi_offsets = self.a0_hi.offsets if hi else None
            adt = self._accel_dtype

            def _amul_local(mg_l, hi_vals_l, v_l):
                if hi:
                    return dia_spmv_ring_local(hi_offsets, ndev, axis,
                                               hi_vals_l, v_l)
                return dia_spmv_ring_local(
                    mg_l.levels[0].a.offsets, ndev, axis,
                    mg_l.levels[0].a.vals, v_l)

            def _prec_local(mg_l, r_l):
                rn = norm2(r_l, axis)
                scale = jnp.where(rn > 0, rn, 1.0)
                r_lo = (r_l / scale).astype(self.dtype)
                e = cycle_spmd(mg_l, jnp.zeros_like(r_lo), r_lo, pars,
                               E, axis, ndev, m_local)
                return e.astype(adt) * scale

            # placeholder when running the outer loop in f32 (amul then
            # reads the sharded hierarchy's own level-0 operator)
            self._hi_vals = self.a0_hi.vals if hi else jax.device_put(
                jnp.zeros((1, self.pad), self.dtype),
                NamedSharding(self.mesh, P(None, self.axis)))
            self._wire_accel(specs, P(None, self.axis), _amul_local,
                             _prec_local)

    def _wire_accel(self, specs, hi_spec, amul_local, prec_local):
        """Build the four jitted shard_map FCG entry points (init, step,
        residual-replacement refresh, truth norm) — shared by the
        embedded and general modes, whose only differences are the amul
        and preconditioner callables."""
        from jax import shard_map
        from ..solve.krylov import fcg_init, fcg_step, fcg_refresh

        axis = self.axis

        def _init(mg_l, hi, x_l, b_l):
            st = fcg_init(lambda v: amul_local(mg_l, hi, v),
                          lambda r: prec_local(mg_l, r), b_l, x_l,
                          axis_name=axis)
            return st, norm2(st[1], axis)

        def _step(mg_l, hi, st):
            return fcg_step(lambda v: amul_local(mg_l, hi, v),
                            lambda r: prec_local(mg_l, r), st,
                            axis_name=axis)

        def _refresh(mg_l, hi, st, b_l):
            return fcg_refresh(lambda v: amul_local(mg_l, hi, v),
                               lambda r: prec_local(mg_l, r), b_l, st,
                               axis_name=axis)

        def _truenorm(mg_l, hi, x_l, b_l):
            return norm2(b_l - amul_local(mg_l, hi, x_l), axis)

        st_specs = ((P(axis),) * 4 + (P(),))

        def mk(f, ins, outs):
            return jax.jit(shard_map(f, mesh=self.mesh, in_specs=ins,
                                     out_specs=outs))

        self._accel_init_fn = mk(_init,
                                 (specs, hi_spec, P(axis), P(axis)),
                                 (st_specs, P()))
        self._accel_step_fn = mk(_step, (specs, hi_spec, st_specs),
                                 (st_specs, P()))
        self._accel_refresh_fn = mk(_refresh,
                                    (specs, hi_spec, st_specs, P(axis)),
                                    (st_specs, P()))
        self._true_resnorm_fn = mk(_truenorm,
                                   (specs, hi_spec, P(axis), P(axis)),
                                   P())

    def _init_general(self, mg, pars):
        """Wire the general sharded cycle (no embedding): levels 0..Es
        row-sharded WEll/Dia/BandedBlocks with real P/R ring transfers,
        all_gather boundary, replicated tail.  Exposes the same _step_fn
        / _accel_*_fn surface as the embedded mode, so solve()/solve_pcg()
        run unchanged."""
        import dataclasses

        from jax import shard_map
        from jax.sharding import NamedSharding
        from .dist import shard_hierarchy, shard_vector, _replicated

        Es, axis, ndev = self.Es, self.axis, self.ndev
        self.pad = mg.levels[0].pad
        if self.pad % ndev:
            raise ValueError(
                f"padded rows {self.pad} not divisible by mesh {ndev}")
        self.m_local = self.pad // ndev
        self.dtype = jnp.dtype(self.pars.dtype)
        pars = self.pars

        boundary_ring = (isinstance(mg.levels[Es].r, WEll)
                         and mg.levels[Es].r.ring_plan is not None
                         and isinstance(mg.levels[Es].p, WEll))
        self.mg = shard_hierarchy(mg, self.mesh, pars,
                                  replicate_from_level=Es + 1)
        specs_levels = [
            _level_specs(lvl, l <= Es, axis)
            for l, lvl in enumerate(self.mg.levels)
        ]
        if not boundary_ring:
            # fallback boundary: the transfers stay replicated (the
            # fine residual is all_gathered instead)
            blvl = mg.levels[Es]
            put = lambda m: jax.tree_util.tree_map(
                lambda v: jax.device_put(v, _replicated(self.mesh)), m)
            self.mg = Hierarchy(
                levels=tuple(
                    dataclasses.replace(l_, p=put(blvl.p), r=put(blvl.r))
                    if i == Es else l_
                    for i, l_ in enumerate(self.mg.levels)),
                coarse_inv=self.mg.coarse_inv)
            specs_levels[Es] = dataclasses.replace(
                specs_levels[Es],
                p=_mat_specs(blvl.p, False, axis),
                r=_mat_specs(blvl.r, False, axis))
        specs = Hierarchy(levels=tuple(specs_levels), coarse_inv=P())

        def _step_local(mg_l, x_l, b_l):
            x_l = cycle_general(mg_l, x_l, b_l, pars, Es, axis, ndev)
            r_l = b_l - _ring_spmv(mg_l.levels[0].a, x_l, axis, ndev)
            return x_l, norm2(r_l, axis)

        self._step_fn = jax.jit(shard_map(
            _step_local, mesh=self.mesh,
            in_specs=(specs, P(axis), P(axis)),
            out_specs=(P(axis), P()),
        ))
        self._shard_vector = lambda v: shard_vector(v, self.mesh)

        # -- FCG wrap: f64 outer against a df64 ring WEll operator ------
        self.a0_hi = None
        if pars.accel == "cg":
            from ..solve.krylov import fcg_init, fcg_step

            hi = pars.refine and self.dtype != jnp.float64
            self._accel_dtype = jnp.float64 if hi else self.dtype
            if hi:
                a0 = self.host_hierarchy.a[0]
                w_hi = WEll.from_csr_df64(a0, pad_rows_to=self.pad,
                                          pad_cols_to=self.pad,
                                          ring_devices=ndev)
                if w_hi.ring_plan is None:
                    hi = False
                    self._accel_dtype = self.dtype
                else:
                    gput = NamedSharding(self.mesh,
                                         P(axis, None, None, None))
                    self.a0_hi = WEll(
                        jax.device_put(w_hi.vals, gput),
                        jax.device_put(w_hi.loc, gput),
                        jax.device_put(
                            w_hi.base,
                            NamedSharding(self.mesh, P(axis, None))),
                        w_hi.shape, w_hi.nnz, w_hi.pad_cols,
                        jax.device_put(w_hi.vals_lo, gput),
                        w_hi.ring_plan)
            adt = self._accel_dtype

            def _amul_local(mg_l, hi_w, v_l):
                if hi:
                    lo128, hi128 = hi_w.ring_plan
                    from .halo import well_spmv_ring_local_df64

                    return well_spmv_ring_local_df64(
                        hi_w, v_l, axis, ndev, lo128, hi128)
                return _ring_spmv(mg_l.levels[0].a, v_l, axis, ndev)

            def _prec_local(mg_l, r_l):
                rn = norm2(r_l, axis)
                scale = jnp.where(rn > 0, rn, 1.0)
                r_lo = (r_l / scale).astype(self.dtype)
                e = cycle_general(mg_l, jnp.zeros_like(r_lo), r_lo, pars,
                                  Es, axis, ndev)
                return e.astype(adt) * scale

            if hi:
                self._hi_vals = self.a0_hi
                hi_spec = _mat_specs(self.a0_hi, True, axis)
            else:
                self._hi_vals = jax.device_put(
                    jnp.zeros((1, self.pad), self.dtype),
                    NamedSharding(self.mesh, P(None, axis)))
                hi_spec = P(None, axis)
            self._wire_accel(specs, hi_spec, _amul_local, _prec_local)

    def solve_pcg(self, b, x0=None):
        """Distributed AMG-preconditioned flexible CG: psum dots, the
        sharded V-cycle as preconditioner, f64 outer iteration against
        the exact row-sharded operator when ``pars.refine`` (the robust
        mode for the sparsified 10M-row recipe)."""
        import time

        from ..params import SolveInfo
        from ..solve.driver import print_itinfo
        from .multihost import fetch

        pars = self.pars
        n = self.a.n_rows
        adt = np.dtype(self._accel_dtype)
        bd = np.zeros(self.pad, dtype=adt)
        bv = np.asarray(b, dtype=adt)[:n]
        bd[:n] = bv[self._perm0] if self._perm0 is not None else bv
        xd = np.zeros(self.pad, dtype=adt)
        if x0 is not None:
            xv = np.asarray(x0, dtype=adt)[:n]
            xd[:n] = xv[self._perm0] if self._perm0 is not None else xv
        bd = self._shard_vector(bd)
        xd = self._shard_vector(xd)

        info = SolveInfo()
        sumb = float(norm2(jnp.asarray(bd)))
        t0 = time.perf_counter()
        if pars.verbose:
            print_itinfo(pars.stop_type, 0, 1.0, sumb, 0.0)
        if sumb == 0.0:
            return np.zeros(n), info
        st, absres_d = self._accel_init_fn(self.mg, self._hi_vals, xd, bd)
        absres0 = float(absres_d)
        info.residuals.append(absres0)
        from ..solve.driver import fcg_host_loop

        xd = fcg_host_loop(
            pars, sumb, st, absres0,
            step=lambda s: self._accel_step_fn(self.mg, self._hi_vals, s),
            refresh=lambda s: self._accel_refresh_fn(
                self.mg, self._hi_vals, s, bd),
            truenorm=lambda x: self._true_resnorm_fn(
                self.mg, self._hi_vals, x, bd),
            info=info)
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        xh = fetch(xd)[:n]
        if self._iperm0 is not None:
            xh = xh[self._iperm0]
        return xh, info

    def solve(self, b, x0=None):
        """Host loop over the jitted shard_map step (same stopping rules
        as AMGSolver.solve).  Dispatches to :meth:`solve_pcg` when
        ``pars.accel == "cg"``."""
        import time

        from ..params import SolveInfo
        from ..solve.driver import print_itinfo

        pars = self.pars
        if pars.accel == "cg":
            return self.solve_pcg(b, x0)
        n = self.a.n_rows
        bd = np.zeros(self.pad, dtype=self.dtype)
        bv = np.asarray(b, dtype=self.dtype)[:n]
        bd[:n] = bv[self._perm0] if self._perm0 is not None else bv
        xd = np.zeros(self.pad, dtype=self.dtype)
        if x0 is not None:
            xv = np.asarray(x0, dtype=self.dtype)[:n]
            xd[:n] = xv[self._perm0] if self._perm0 is not None else xv
        bd = self._shard_vector(bd)
        xd = self._shard_vector(xd)

        info = SolveInfo()
        sumb = float(norm2(jnp.asarray(bd)))
        t0 = time.perf_counter()
        if pars.verbose:
            print_itinfo(pars.stop_type, 0, 1.0, sumb, 0.0)
        if sumb == 0.0:
            return np.zeros(n), info
        absres0 = sumb
        # quiet mode batches residual fetches (each device->host fetch
        # is a sync that stalls the dispatch queue)
        check_every = 1 if pars.verbose else 4
        pending = []
        stop = False
        for it in range(1, pars.max_it + 1):
            xd, absres_d = self._step_fn(self.mg, xd, bd)
            pending.append((it, xd, absres_d))
            if len(pending) >= check_every or it == pars.max_it:
                vals = np.asarray(jnp.stack([r for _, _, r in pending]))
                for (it_i, x_i, _), absres in zip(pending, vals):
                    absres = float(absres)
                    relres = absres / sumb
                    factor = absres / absres0 if absres0 > 0 else 0.0
                    absres0 = absres
                    if pars.verbose:
                        print_itinfo(pars.stop_type, it_i, relres, absres,
                                     factor)
                    if not np.isfinite(absres):
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
        from .multihost import fetch

        xh = fetch(xd)[:n]
        if self._iperm0 is not None:
            xh = xh[self._iperm0]
        return xh, info
