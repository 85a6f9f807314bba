"""Solve-phase tests: smoothers, Krylov, cycle, end-to-end convergence."""

import numpy as np
import pytest

import amg_tpu as amg
from amg_tpu.params import (
    AMGParams, SmootherType, InterpType, CoarsestSolver,
)
from amg_tpu.sparse import CSR, Ell
from amg_tpu.hierarchy import setup, _level_from_csr
from amg_tpu.solve.smoothers import smooth, gs_sweep, _order
from amg_tpu.solve.krylov import cg, gmres


def _mk_level(a: CSR, cfmark=None, pars=AMGParams(), force_ell=False):
    import jax.numpy as jnp

    if force_ell:
        pars = pars.replace(max_diags=0, dense_level_bytes=0)
    pad = ((a.n_rows + 7) // 8) * 8
    return _level_from_csr(a, None, None, cfmark, pad, None,
                           jnp.float64, pars)


def _gs_oracle(a: CSR, x, b, order_rows):
    """Sequential GS in a given row order (numpy oracle)."""
    x = x.copy()
    d = a.to_dense()
    for i in order_rows:
        t = b[i] - d[i] @ x + d[i, i] * x[i]
        if abs(d[i, i]) > 1e-20:
            x[i] = t / d[i, i]
    return x


def test_colored_gs_is_exact_gs():
    """The multicolor sweep equals sequential GS in the colored order."""
    a = amg.poisson2d(6)
    n = a.n_rows
    level = _mk_level(a, force_ell=True)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(n)
    b = rng.standard_normal(n)

    import jax.numpy as jnp

    pad = level.pad
    xp = np.zeros(pad); xp[:n] = x0
    bp = np.zeros(pad); bp[:n] = b
    order = _order(level, True, 0, True)
    got = np.asarray(gs_sweep(level, jnp.asarray(xp), jnp.asarray(bp), order))[:n]

    # oracle: same ordering flattened
    groups = np.asarray(level.groups)
    rows = [r for g in order for r in groups[g] if r < n]
    want = _gs_oracle(a, x0, b, rows)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_masked_gs_matches_group_gs():
    """The DIA masked-GS path produces the same sweep as the ELL group
    path (both are exact GS in the colored ordering)."""
    import jax.numpy as jnp

    a = amg.poisson2d(7)
    n = a.n_rows
    lvl_dia = _mk_level(a)
    lvl_ell = _mk_level(a, force_ell=True)
    from amg_tpu.sparse import Dia as _Dia

    assert isinstance(lvl_dia.a, _Dia)
    rng_ = np.random.default_rng(3)
    pad = lvl_dia.pad
    x = np.zeros(pad); x[:n] = rng_.standard_normal(n)
    b = np.zeros(pad); b[:n] = rng_.standard_normal(n)
    order = _order(lvl_dia, True, 0, True)
    y1 = np.asarray(gs_sweep(lvl_dia, jnp.asarray(x), jnp.asarray(b), order))
    y2 = np.asarray(gs_sweep(lvl_ell, jnp.asarray(x), jnp.asarray(b), order))
    np.testing.assert_allclose(y1[:n], y2[:n], rtol=1e-12, atol=1e-13)


def test_groups_partition_rows():
    a = amg.poisson2d(9)
    level = _mk_level(a, force_ell=True)
    groups = np.asarray(level.groups)
    rows = groups[groups < a.n_rows]
    assert sorted(rows.tolist()) == list(range(a.n_rows))
    # within a group, no two rows are adjacent in A
    d = a.to_dense() != 0
    for g in groups:
        g = g[g < a.n_rows]
        sub = d[np.ix_(g, g)]
        np.fill_diagonal(sub, False)
        assert not sub.any()


def test_cf_groups_order():
    a = amg.poisson2d(8)
    from amg_tpu.setup_phase.strength import strength_matrix
    from amg_tpu.setup_phase.cf_split import rs_split

    vec, _ = rs_split(strength_matrix(a))
    level = _mk_level(a, cfmark=vec)
    pre = _order(level, True, 1, True)
    post = _order(level, True, 1, False)
    # pre: all F groups before C groups; post: reverse
    cf = [level.group_cf[g] for g in pre]
    assert cf == sorted(cf)
    cf_post = [level.group_cf[g] for g in post]
    assert cf_post == sorted(cf_post, reverse=True)


@pytest.mark.parametrize("sm", [
    SmootherType.GS, SmootherType.SGS, SmootherType.JACOBI,
    SmootherType.WJACOBI, SmootherType.L1DIAG, SmootherType.SOR,
    SmootherType.SSOR, SmootherType.POLY, SmootherType.GSOR,
    SmootherType.SGSOR, SmootherType.CG,
])
def test_smoothers_reduce_error(sm):
    a = amg.poisson2d(8)
    n = a.n_rows
    pars = AMGParams(smoother=sm, relax=0.8)
    level = _mk_level(a, pars=pars)
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(n)
    b = a.matvec(x_true)
    pad = level.pad
    xp = np.zeros(pad)
    bp = np.zeros(pad); bp[:n] = b

    import jax.numpy as jnp

    x = jnp.asarray(xp)
    e0 = np.linalg.norm(x_true)
    for _ in range(10):
        x = smooth(level, x, jnp.asarray(bp), pars, 1, pre=True)
    e1 = np.linalg.norm(np.asarray(x)[:n] - x_true)
    assert e1 < 0.7 * e0, f"{sm.name}: {e1} !< 0.7*{e0}"


def test_cg_solves_spd(rng):
    a = amg.poisson2d(10)
    e = Ell.from_csr(a)
    import jax.numpy as jnp

    n, pad = a.n_rows, e.padded_rows
    x_true = rng.standard_normal(n)
    b = np.zeros(pad); b[:n] = a.matvec(x_true)
    x, conv = cg(e, jnp.asarray(b), jnp.zeros(pad), tol=1e-10, maxit=500)
    assert bool(conv)
    np.testing.assert_allclose(np.asarray(x)[:n], x_true, rtol=1e-7, atol=1e-8)


def test_gmres_solves_nonsymmetric(rng):
    n = 24
    d = np.diag(np.arange(2.0, 2.0 + n)) + 0.3 * np.triu(np.ones((n, n)), 1)
    a = CSR.from_dense(d)
    e = Ell.from_csr(a)
    import jax.numpy as jnp

    pad = e.padded_rows
    x_true = rng.standard_normal(n)
    b = np.zeros(pad); b[:n] = d @ x_true
    x, conv = gmres(e, jnp.asarray(b), jnp.zeros(pad), tol=1e-10,
                    maxit=300, restart=20)
    assert bool(conv)
    np.testing.assert_allclose(np.asarray(x)[:n], x_true, rtol=1e-6, atol=1e-7)


def test_vcycle_converges_poisson():
    a = amg.poisson2d(32)
    pars = AMGParams(verbose=0)
    solver = amg.AMGSolver(a, pars)
    b = np.ones(a.n_rows)
    x, info = solver.solve(b)
    assert info.rres < 1e-6
    assert info.nits <= 15
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6


def test_vcycle_converges_bus(bus1138):
    pars = AMGParams(verbose=0)
    solver = amg.AMGSolver(bus1138, pars)
    b = np.ones(1138)
    x, info = solver.solve(b, x0=np.ones(1138))
    assert info.rres < 1e-6
    assert info.nits <= 40
    r = b - bus1138.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6


def test_solve_jit_matches_host_loop():
    a = amg.poisson2d(16)
    pars = AMGParams(verbose=0)
    solver = amg.AMGSolver(a, pars)
    b = np.ones(a.n_rows)
    x1, info1 = solver.solve(b)
    x2, info2 = solver.solve_jit(b)
    assert info1.nits == info2.nits
    np.testing.assert_allclose(x1, x2, rtol=1e-12)


def test_wcycle_converges():
    a = amg.poisson2d(24)
    pars = AMGParams(cycle_type=2, verbose=0, max_levels=5)
    solver = amg.AMGSolver(a, pars)
    x, info = solver.solve(np.ones(a.n_rows))
    assert info.rres < 1e-6
    # W-cycle should converge at least as fast as V
    pars_v = AMGParams(cycle_type=1, verbose=0, max_levels=5)
    _, info_v = amg.AMGSolver(a, pars_v).solve(np.ones(a.n_rows))
    assert info.nits <= info_v.nits


def test_std_interp_converges():
    a = amg.poisson2d(24)
    pars = AMGParams(interp_type=InterpType.STD, verbose=0)
    solver = amg.AMGSolver(a, pars)
    x, info = solver.solve(np.ones(a.n_rows))
    assert info.rres < 1e-6


def test_krylov_coarsest_converges():
    a = amg.poisson2d(16)
    pars = AMGParams(coarsest_solver=CoarsestSolver.KRYLOV, verbose=0)
    solver = amg.AMGSolver(a, pars)
    x, info = solver.solve(np.ones(a.n_rows))
    assert info.rres < 1e-6


def test_float32_mode():
    a = amg.poisson2d(16)
    pars = AMGParams(dtype="float32", tol=1e-5, verbose=0)
    solver = amg.AMGSolver(a, pars)
    x, info = solver.solve(np.ones(a.n_rows))
    assert info.rres < 1e-5


def test_anisotropic_poisson():
    a = amg.poisson2d(24, epsilon=0.01)
    pars = AMGParams(verbose=0)
    solver = amg.AMGSolver(a, pars)
    x, info = solver.solve(np.ones(a.n_rows))
    assert info.rres < 1e-6


def test_zero_rhs_short_circuit():
    a = amg.poisson2d(8)
    x, info = amg.solver_amg(a, np.ones(64), np.zeros(64),
                             AMGParams(verbose=0))
    np.testing.assert_allclose(x, 0.0)
    assert info.nits == 0


def test_3d_poisson():
    a = amg.poisson3d(10)
    pars = AMGParams(verbose=0)
    solver = amg.AMGSolver(a, pars)
    x, info = solver.solve(np.ones(a.n_rows))
    assert info.rres < 1e-6


def test_tight_tolerance_1e8():
    """North-star tolerance: 1e-8 relative residual (BASELINE.md)."""
    a = amg.poisson2d(32)
    pars = AMGParams(tol=1e-8, verbose=0)
    solver = amg.AMGSolver(a, pars)
    b = np.ones(a.n_rows)
    x, info = solver.solve(b)
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def test_range_gs_matches_gather_gs():
    """The color-contiguous range GS (reorder_gs levels) computes the same
    sweep as the gather-based group GS on the permuted matrix."""
    import jax.numpy as jnp
    from amg_tpu.setup_phase.coloring import color_graph
    from amg_tpu.hierarchy import _level_from_csr

    a = amg.poisson2d(7)
    n = a.n_rows
    colors = color_graph(a)
    key = colors.astype(np.int64) * 2
    perm = np.argsort(key, kind="stable")
    ap = a.permute(perm)
    gs_key = key[perm]

    pars = AMGParams(max_diags=0, dense_level_bytes=0)  # force ELL
    pad = ((n + 7) // 8) * 8
    lvl_rng = _level_from_csr(ap, None, None, None, pad, None,
                              jnp.float64, pars, gs_key=gs_key)
    lvl_gat = _level_from_csr(ap, None, None, None, pad, None,
                              jnp.float64, pars)
    assert lvl_rng.ranges is not None and lvl_gat.ranges is None

    rng_ = np.random.default_rng(5)
    x = np.zeros(pad); x[:n] = rng_.standard_normal(n)
    b = np.zeros(pad); b[:n] = rng_.standard_normal(n)

    # range path sweeps classes in range order == sorted key order
    y1 = np.asarray(gs_sweep(lvl_rng, jnp.asarray(x), jnp.asarray(b),
                             tuple(range(len(lvl_rng.ranges)))))
    # oracle: sequential GS in permuted row order (rows already sorted by key)
    want = _gs_oracle(ap, x[:n], b[:n], list(range(n)))
    np.testing.assert_allclose(y1[:n], want, rtol=1e-12, atol=1e-13)


def test_reorder_gs_solve_equivalent():
    """reorder_gs=True converges like the unpermuted hierarchy and returns
    the solution in the user's ordering."""
    a = amg.poisson3d(12)
    b = np.random.default_rng(1).standard_normal(a.n_rows)
    xs = {}
    for reorder in (False, True):
        pars = AMGParams(tol=1e-10, verbose=0, reorder_gs=reorder)
        s = amg.AMGSolver(a, pars, log=lambda *a: None)
        x, info = s.solve(b)
        r = b - a.matvec(x)
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-9
        xs[reorder] = x
    np.testing.assert_allclose(xs[False], xs[True], rtol=1e-7, atol=1e-9)


def test_dense_level_format():
    """Small levels densify (MXU matvec path) and GS on them is exact."""
    import jax.numpy as jnp
    from amg_tpu.sparse import Dense
    from amg_tpu.ops.spmv import spmv

    a = amg.poisson2d(9)
    d = Dense.from_csr(a, dtype=jnp.float64)
    x = np.random.default_rng(0).standard_normal(d.padded_cols)
    y = np.asarray(spmv(d, jnp.asarray(x)))[: a.n_rows]
    np.testing.assert_allclose(y, a.matvec(x[: a.n_cols]), rtol=1e-12)

    # dense range-GS equals the sequential oracle in the permuted order
    from amg_tpu.setup_phase.coloring import color_graph
    n = a.n_rows
    colors = color_graph(a)
    key = colors.astype(np.int64) * 2
    perm = np.argsort(key, kind="stable")
    ap = a.permute(perm)
    pars = AMGParams(max_diags=0)  # skip DIA so dense wins
    pad = ((n + 127) // 128) * 128
    lvl = _mk_level_padded(ap, pad, pars, gs_key=key[perm])
    from amg_tpu.sparse import Dense as _Dense
    assert isinstance(lvl.a, _Dense) and lvl.ranges is not None
    rng_ = np.random.default_rng(5)
    x = np.zeros(pad); x[:n] = rng_.standard_normal(n)
    b = np.zeros(pad); b[:n] = rng_.standard_normal(n)
    y1 = np.asarray(gs_sweep(lvl, jnp.asarray(x), jnp.asarray(b),
                             tuple(range(len(lvl.ranges)))))
    want = _gs_oracle(ap, x[:n], b[:n], list(range(n)))
    np.testing.assert_allclose(y1[:n], want, rtol=1e-12, atol=1e-13)


def _mk_level_padded(a, pad, pars, gs_key=None):
    import jax.numpy as jnp

    return _level_from_csr(a, None, None, None, pad, None,
                           jnp.float64, pars, gs_key=gs_key)


def test_dense_levels_end_to_end():
    a = amg.poisson3d(16)
    pars = AMGParams(tol=1e-8, verbose=0)
    s = amg.AMGSolver(a, pars, log=lambda *a: None)
    fmts = [type(l.a).__name__ for l in s.mg.levels]
    assert "Dense" in fmts
    b = np.ones(a.n_rows)
    x, info = s.solve(b)
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def test_mixed_precision_refine():
    """f32 cycles + f64 defect correction reach f64-grade tolerance."""
    a = amg.poisson3d(12)
    b = np.random.default_rng(7).standard_normal(a.n_rows)
    pars = AMGParams(tol=1e-10, dtype="float32", refine=True, verbose=0)
    s = amg.AMGSolver(a, pars, log=lambda *a: None)
    assert s.a0_hi is not None
    x, info = s.solve(b)
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10
    # plain f32 cannot reach this tolerance
    pars32 = AMGParams(tol=1e-10, dtype="float32", max_it=40, verbose=0)
    _, info32 = amg.AMGSolver(a, pars32, log=lambda *a: None).solve(b)
    assert info32.rres > 1e-10


def test_quiet_solve_matches_verbose():
    """Batched residual fetching (quiet mode) reproduces the per-iteration
    sync path exactly."""
    a = amg.poisson2d(24)
    b = np.ones(a.n_rows)
    i1 = amg.AMGSolver(a, AMGParams(verbose=1), log=lambda *a: None).solve(b)[1]
    i0 = amg.AMGSolver(a, AMGParams(verbose=0), log=lambda *a: None).solve(b)[1]
    assert i1.nits == i0.nits
    np.testing.assert_allclose(
        i1.residuals, i0.residuals[: len(i1.residuals)], rtol=1e-12
    )


def test_embedded_levels_match_compact():
    """Fine-grid-embedded coarse levels reproduce the compact hierarchy's
    convergence (same numerics, different layout)."""
    from amg_tpu.params import SmootherType

    a = amg.poisson3d(14)
    b = np.random.default_rng(11).standard_normal(a.n_rows)
    pars_e = AMGParams(tol=1e-10, verbose=0, embed_levels=8)
    s_e = amg.AMGSolver(a, pars_e, log=lambda *x: None)
    # the plan must actually embed at least level 1 on a 3D stencil
    assert s_e.mg.levels[1].pad == s_e.mg.levels[0].pad
    pars_c = AMGParams(tol=1e-10, verbose=0, embed_levels=0)
    s_c = amg.AMGSolver(a, pars_c, log=lambda *x: None)
    assert s_c.mg.levels[1].pad != s_c.mg.levels[0].pad

    x_e, info_e = s_e.solve(b)
    x_c, info_c = s_c.solve(b)
    r_e = b - a.matvec(x_e)
    assert np.linalg.norm(r_e) / np.linalg.norm(b) < 1e-10
    assert abs(info_e.nits - info_c.nits) <= 1
    np.testing.assert_allclose(x_e, x_c, rtol=1e-6, atol=1e-9)


def test_embedded_chebyshev_coarse():
    from amg_tpu.params import SmootherType

    a = amg.poisson3d(14)
    b = np.ones(a.n_rows)
    pars = AMGParams(tol=1e-8, verbose=0, embed_levels=8,
                     coarse_smoother=SmootherType.CHEBYSHEV)
    s = amg.AMGSolver(a, pars, log=lambda *x: None)
    x, info = s.solve(b)
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8
    assert info.nits <= 20


def test_embedded_spmv_matches_compact():
    """Embedded-space P/R/A applications equal the compact ones."""
    import jax.numpy as jnp
    from amg_tpu.hierarchy import (setup_host, embedding_plan, to_device)
    from amg_tpu.ops.spmv import spmv

    a = amg.poisson3d(10)
    pars = AMGParams(verbose=0, embed_levels=8)
    hh = setup_host(a, pars, log=lambda *x: None)
    plan = embedding_plan(hh, pars)
    E, emb = plan[0], plan[1]
    assert E >= 1
    mg = to_device(hh, pars, plan=plan)

    rng_ = np.random.default_rng(0)
    n0 = a.n_rows
    pad0 = mg.levels[0].pad
    # A_1 embedded vs host CSR
    x1 = rng_.standard_normal(hh.a[1].n_rows)
    xe = np.zeros(pad0)
    xe[emb[1]] = x1
    ye = np.asarray(spmv(mg.levels[1].a, jnp.asarray(xe)))
    want = hh.a[1].matvec(x1)
    np.testing.assert_allclose(ye[emb[1]], want, rtol=1e-12, atol=1e-13)
    # non-member rows stay zero
    mask = np.ones(pad0, bool)
    mask[emb[1]] = False
    assert np.abs(ye[mask]).max() == 0.0
    # P_0 embedded
    ype = np.asarray(spmv(mg.levels[0].p, jnp.asarray(xe)))
    want_p = hh.p[0].matvec(x1)
    np.testing.assert_allclose(ype[:n0], want_p, rtol=1e-12, atol=1e-13)


def test_bf16_coarse_operators():
    """bf16 coarse-operator storage converges like f32 under defect
    correction."""
    from amg_tpu.params import SmootherType

    a = amg.poisson3d(14)
    b = np.random.default_rng(9).standard_normal(a.n_rows)
    pars = AMGParams(tol=1e-10, dtype="float32", refine=True, verbose=0,
                     coarse_smoother=SmootherType.CHEBYSHEV,
                     coarse_op_dtype="bfloat16")
    s = amg.AMGSolver(a, pars, log=lambda *x: None)
    import jax.numpy as jnp
    assert s.mg.levels[1].a.vals.dtype == jnp.bfloat16
    x, info = s.solve(b)
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_fcg_accel_converges_fewer_cycles():
    """AMG-preconditioned flexible CG reaches tol in <= the stand-alone
    cycle count, and solves correctly in f64."""
    a = amg.poisson3d(12)
    b = np.random.default_rng(3).standard_normal(a.n_rows)
    tol = 1e-8
    plain = amg.AMGSolver(a, AMGParams(tol=tol, verbose=0),
                          log=lambda *a: None)
    _, info_p = plain.solve(b)
    acc = amg.AMGSolver(a, AMGParams(tol=tol, verbose=0, accel="cg"),
                        log=lambda *a: None)
    x, info_a = acc.solve(b)
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < tol
    assert info_a.nits <= info_p.nits


def test_fcg_accel_mixed_precision():
    """accel=cg + refine: f32 preconditioner cycles inside an f64 FCG
    outer iteration reach f64-grade tolerance."""
    a = amg.poisson3d(12)
    b = np.random.default_rng(5).standard_normal(a.n_rows)
    pars = AMGParams(tol=1e-10, dtype="float32", refine=True,
                     accel="cg", verbose=0)
    s = amg.AMGSolver(a, pars, log=lambda *a: None)
    x, info = s.solve(b)
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_fcg_full_jit_matches_host_loop():
    """krylov.fcg (one while_loop) agrees with the host-loop FCG."""
    import jax.numpy as jnp
    from amg_tpu.solve.krylov import fcg
    from amg_tpu.solve.cycle import cycle as amg_cycle

    a = amg.poisson2d(16)
    pars = AMGParams(verbose=0, accel="cg")
    s = amg.AMGSolver(a, pars, log=lambda *a: None)
    b = np.ones(a.n_rows)
    x1, info1 = s.solve(b)

    bd = jnp.zeros(s.pad).at[: a.n_rows].set(b)
    prec = lambda r: amg_cycle(s.mg, jnp.zeros_like(r), r, pars)
    x2, nits, absres = fcg(s.mg.levels[0].a, bd, jnp.zeros(s.pad),
                           tol=pars.tol, maxit=pars.max_it, M=prec)
    assert int(nits) == info1.nits
    np.testing.assert_allclose(np.asarray(x2)[: a.n_rows], x1,
                               rtol=1e-10, atol=1e-12)


def test_compact_boundary_matches_embedded():
    """embed_boundary="compact" (no embedded P_E/R_E arrays) converges the
    same as the embedded boundary and yields the same solution."""
    a = amg.poisson3d(14)
    b = np.random.default_rng(11).standard_normal(a.n_rows)
    base = AMGParams(verbose=0, embed_levels=2,
                     coarse_smoother=SmootherType.CHEBYSHEV)
    s_emb = amg.AMGSolver(a, base.replace(embed_boundary="embedded"),
                          log=lambda *a: None)
    s_cmp = amg.AMGSolver(a, base.replace(embed_boundary="compact"),
                          log=lambda *a: None)
    # both must actually embed, and the compact variant must carry the
    # member-index boundary instead of embedded P/R stencils
    from amg_tpu.sparse import Ell, Dia
    assert s_emb.mg.levels[0].compact_idx is None
    lb_emb = next(l for l in s_emb.mg.levels if l.compact_idx is not None)
    lb_cmp = next(l for l in s_cmp.mg.levels if l.member_idx is not None)
    assert isinstance(lb_emb.p, Dia) and isinstance(lb_cmp.p, Ell)
    x1, i1 = s_emb.solve(b)
    x2, i2 = s_cmp.solve(b)
    assert i1.rres < 1e-6 and i2.rres < 1e-6
    assert abs(i1.nits - i2.nits) <= 1
    r = b - a.matvec(x2)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6


def test_sa_coarsening_converges():
    """Smoothed-aggregation hierarchy solves Poisson; coarsening is much
    more aggressive than RS (fewer total coarse rows)."""
    from amg_tpu.params import CoarsenType

    a = amg.poisson3d(12)
    b = np.random.default_rng(13).standard_normal(a.n_rows)
    sa = amg.AMGSolver(a, AMGParams(verbose=0, cs_type=CoarsenType.SA,
                                    max_it=60), log=lambda *a: None)
    x, info = sa.solve(b)
    assert info.rres < 1e-6
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6
    rs = amg.AMGSolver(a, AMGParams(verbose=0), log=lambda *a: None)
    coarse_sa = sum(m.n_rows for m in sa.host_hierarchy.a[1:])
    coarse_rs = sum(m.n_rows for m in rs.host_hierarchy.a[1:])
    assert coarse_sa < coarse_rs


def test_sa_checkpoint_roundtrip():
    """SA hierarchies (cfmark=None levels) survive save/load."""
    import tempfile, os
    from amg_tpu.params import CoarsenType
    from amg_tpu.io.checkpoint import save_hierarchy, load_hierarchy

    a = amg.poisson2d(16)
    s = amg.AMGSolver(a, AMGParams(verbose=0, cs_type=CoarsenType.SA),
                      log=lambda *a: None)
    hh = s.host_hierarchy
    assert any(cf is None for cf in hh.cfmark)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "h.npz")
        save_hierarchy(path, hh)
        hh2 = load_hierarchy(path)
    assert hh2.num_levels == hh.num_levels
    assert all((c1 is None) == (c2 is None)
               for c1, c2 in zip(hh.cfmark, hh2.cfmark))


def test_pgmres_accel_nonsymmetric():
    """AMG-right-preconditioned GMRES solves an upwind convection-diffusion
    system (nonsymmetric) where plain CG theory does not apply."""
    n_side = 24
    h = 1.0 / (n_side + 1)
    vel = 20.0  # convection strength
    # 2D convection-diffusion, upwind first-order convection in x
    idx = lambda i, j: i * n_side + j
    rows, cols, vals = [], [], []
    for i in range(n_side):
        for j in range(n_side):
            k = idx(i, j)
            diag = 4.0 / h**2 + vel / h
            rows.append(k); cols.append(k); vals.append(diag)
            for di, dj, c in ((-1, 0, -1.0 / h**2 - vel / h),
                              (1, 0, -1.0 / h**2),
                              (0, -1, -1.0 / h**2),
                              (0, 1, -1.0 / h**2)):
                ii, jj = i + di, j + dj
                if 0 <= ii < n_side and 0 <= jj < n_side:
                    rows.append(k); cols.append(idx(ii, jj)); vals.append(c)
    a = CSR.from_coo(rows, cols, vals, (n_side**2, n_side**2))
    d = a.to_dense()
    assert not np.allclose(d, d.T)  # genuinely nonsymmetric
    b = np.random.default_rng(17).standard_normal(a.n_rows)
    s = amg.AMGSolver(a, AMGParams(verbose=0, accel="gmres", tol=1e-8),
                      log=lambda *a: None)
    x, info = s.solve(b)
    r = b - a.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8
    assert info.nits <= 40


def test_banded_level_solve_matches_ell():
    """Forcing the BandedBlocks format on coarse levels reproduces the
    ELL-format solve (same hierarchy numerics, different storage)."""
    a = amg.poisson3d(12)
    b = np.random.default_rng(19).standard_normal(a.n_rows)
    base = AMGParams(verbose=0, tol=1e-8, max_diags=0, embed_levels=0,
                     dense_level_bytes=0)  # force ELL everywhere
    s_ell = amg.AMGSolver(a, base.replace(use_banded="off"),
                          log=lambda *x: None)
    s_bb = amg.AMGSolver(a, base.replace(use_banded="on"),
                         log=lambda *x: None)
    from amg_tpu.sparse import BandedBlocks, Ell
    assert any(isinstance(l.a, BandedBlocks) for l in s_bb.mg.levels[1:])
    assert all(isinstance(l.a, Ell) for l in s_ell.mg.levels)
    x1, i1 = s_ell.solve(b)
    x2, i2 = s_bb.solve(b)
    assert i1.rres < 1e-8 and i2.rres < 1e-8
    assert abs(i1.nits - i2.nits) <= 1
    r = b - a.matvec(x2)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def test_stop_types():
    """cg stop-type criteria (reference amg/Solve/SSS_cycle.cu:101-130)
    and the MOD_REL_RES outer criterion all converge."""
    import jax.numpy as jnp
    from amg_tpu.params import StopType

    a = amg.poisson2d(12)
    e = Ell.from_csr(a)
    n, pad = a.n_rows, e.padded_rows
    rng_ = np.random.default_rng(23)
    x_true = rng_.standard_normal(n)
    b = np.zeros(pad); b[:n] = a.matvec(x_true)
    for st in (StopType.REL_RES, StopType.REL_PRECRES,
               StopType.MOD_REL_RES):
        x, conv = cg(e, jnp.asarray(b), jnp.zeros(pad), tol=1e-10,
                     maxit=600, stop_type=st)
        assert bool(conv), st
        np.testing.assert_allclose(np.asarray(x)[:n], x_true,
                                   rtol=1e-6, atol=1e-7)
    # outer loop with MOD_REL_RES stopping
    s = amg.AMGSolver(a, AMGParams(verbose=0,
                                   stop_type=StopType.MOD_REL_RES),
                      log=lambda *x: None)
    xs, info = s.solve(b[:n])
    r = b[:n] - a.matvec(xs)
    assert np.linalg.norm(r) / max(np.linalg.norm(xs), 1e-300) < 1e-6


def test_cli_anisotropic_spec():
    from amg_tpu.cli import load_matrix

    a = load_matrix("anisotropic:8")
    assert a.n_rows == 64
    d = a.to_dense()
    # y-coupling scaled by eps=1e-3, x-coupling unscaled
    assert abs(d[0, 1] + 1.0) < 1e-12 or abs(d[0, 1] + 1e-3) < 1e-12
    a2 = load_matrix("anisotropic:8:0.5")
    assert a2.n_rows == 64


def test_batched_solve_matches_single():
    """solve_batched solves k systems with one hierarchy; each column
    matches the single-rhs solve."""
    a = amg.poisson3d(10)
    rng_ = np.random.default_rng(31)
    k = 5
    B = rng_.standard_normal((a.n_rows, k))
    s = amg.AMGSolver(a, AMGParams(verbose=0, tol=1e-8),
                      log=lambda *x: None)
    X, info = s.solve_batched(B)
    assert info.rres < 1e-8
    for j in range(k):
        r = B[:, j] - a.matvec(X[:, j].astype(np.float64))
        assert np.linalg.norm(r) / np.linalg.norm(B[:, j]) < 1e-8
    # column 0 equals the single solve at the same iteration count
    x0, i0 = s.solve(B[:, 0])
    r0 = B[:, 0] - a.matvec(x0)
    assert np.linalg.norm(r0) / np.linalg.norm(B[:, 0]) < 1e-8


def test_tiny_matrix_single_level():
    """Matrices at or below coarse_dof solve via the dense coarsest path
    (single-level hierarchy, no coarsening)."""
    rng_ = np.random.default_rng(41)
    n = 9  # < MIN_CDOF=10
    d = np.diag(np.arange(2.0, 2.0 + n)) + 0.1 * rng_.standard_normal((n, n))
    d = (d + d.T) / 2 + n * np.eye(n)
    a = CSR.from_dense(d)
    s = amg.AMGSolver(a, AMGParams(verbose=0), log=lambda *x: None)
    assert s.host_hierarchy.num_levels == 1
    b = rng_.standard_normal(n)
    x, info = s.solve(b)
    np.testing.assert_allclose(d @ x, b, rtol=1e-8, atol=1e-10)


def test_zero_diagonal_row_guard():
    """Rows with (near-)zero diagonal keep their old value in GS instead
    of dividing by zero (reference small-diag guard,
    amg/Solve/SSS_smooth.c:30)."""
    import jax.numpy as jnp
    from amg_tpu.solve.smoothers import smooth

    a = amg.poisson2d(6)
    d = a.to_dense()
    d[7, 7] = 0.0  # break one diagonal
    a2 = CSR.from_dense(d)
    level = _mk_level(a2)
    pars = AMGParams()
    n = a2.n_rows
    x = jnp.asarray(np.pad(np.ones(n), (0, level.pad - n)))
    b = jnp.asarray(np.zeros(level.pad))
    y = np.asarray(smooth(level, x, b, pars, 1, pre=True))
    assert np.all(np.isfinite(y))
    assert y[7] == 1.0  # untouched row


def test_cg_safety_nets_near_singular(rng):
    """Reference CG safety nets (amg/Solve/SSS_cycle.cu:238-355).

    A near-singular SPD system drives the recurrence residual away from the
    true residual; with only the recurrence check CG can return a
    silently-bad iterate.  The false-convergence recompute (Check III) must
    re-verify against ``b - A x`` before accepting, so a reported
    ``converged`` implies a small TRUE residual.
    """
    import jax.numpy as jnp
    from amg_tpu.solve.krylov import cg

    n = 60
    # ill-conditioned SPD: eigenvalues span 1e12
    d = np.logspace(-6, 6, n)
    q, _ = np.linalg.qr(np.asarray(np.random.default_rng(5).standard_normal((n, n))))
    mat = (q * d) @ q.T
    mat = 0.5 * (mat + mat.T)
    a = CSR.from_dense(mat)
    e = Ell.from_csr(a)
    pad = e.padded_rows
    x_true = np.random.default_rng(7).standard_normal(n)
    b = np.zeros(pad); b[:n] = mat @ x_true

    x, conv, (status, iters) = cg(e, jnp.asarray(b), jnp.zeros(pad),
                                  tol=1e-8, maxit=2000, return_info=True)
    r_true = b[:n] - mat @ np.asarray(x)[:n]
    rel = np.linalg.norm(r_true) / np.linalg.norm(b)
    if bool(conv):
        # converged verdicts must be backed by the recomputed true residual
        assert rel < 5e-8, rel
        assert int(status) == 1
    else:
        # a safety-net exit reports a meaningful status, not false success
        assert int(status) != 1


def test_cg_stagnation_status_codes():
    """Status-code surface: clean convergence reports 1 under return_info."""
    import jax.numpy as jnp
    from amg_tpu.solve.krylov import cg

    a = amg.poisson2d(10)
    e = Ell.from_csr(a)
    n, pad = a.n_rows, e.padded_rows
    b = np.zeros(pad); b[:n] = 1.0
    x, conv, (status, iters) = cg(e, jnp.asarray(b), jnp.zeros(pad),
                                  tol=1e-10, maxit=500, return_info=True)
    assert bool(conv) and int(status) == 1 and int(iters) > 0


def test_krylov_coarsest_indefinite_fallback():
    """coarsest_solve KRYLOV mode: GMRES fallback fires only on CG failure
    (lax.cond gating, reference amg/Solve/SSS_cycle.cu:837-841).

    A symmetric *indefinite* coarsest system makes plain CG break down;
    the result must still be accurate because GMRES takes over.
    """
    import jax.numpy as jnp
    from amg_tpu.hierarchy import Hierarchy, Level
    from amg_tpu.solve.cycle import coarsest_solve
    from amg_tpu.params import CoarsestSolver

    n = 20
    d = np.diag(np.concatenate([np.arange(1.0, 11.0),
                                -np.arange(1.0, 11.0)]))
    d += 0.1 * (np.eye(n, k=1) + np.eye(n, k=-1))
    a = CSR.from_dense(d)
    e = Ell.from_csr(a)
    pad = e.padded_rows
    x_true = np.random.default_rng(3).standard_normal(n)
    b = np.zeros(pad); b[:n] = d @ x_true

    diag = np.zeros(pad); diag[:n] = np.diag(d)
    jdiag = jnp.asarray(diag)
    lvl = Level(a=e, p=None, r=None, diag=jdiag,
                inv_diag=jnp.where(jnp.abs(jdiag) > 1e-300, 1.0 / jdiag, 0.0),
                l1_inv=jnp.zeros(pad), diag_mask=None, groups=None,
                gid=None, rho_dinv_a=jnp.ones(()), group_cf=())
    mg = Hierarchy(levels=(lvl,), coarse_inv=None)
    pars = AMGParams(coarsest_solver=CoarsestSolver.KRYLOV, verbose=0)
    x = coarsest_solve(mg, jnp.asarray(b), pars, ctol=1e-10)
    np.testing.assert_allclose(np.asarray(x)[:n], x_true, rtol=1e-5,
                               atol=1e-6)


def test_unstructured_fem_solve():
    """Unstructured Delaunay FEM stiffness (thermal2-class stress: irregular
    degrees, positive off-diagonals, 1e3 conductivity jumps) sets up and
    solves to 1e-8 (VERDICT round-1 item 7; reference stress surface
    amg/SSS_matvec.c:398-534 exercised via Galerkin RAP on irregular rows).
    """
    import amg_tpu as amg

    a = amg.fem2d(4000, seed=7)
    b = np.ones(a.n_rows)
    solver = amg.AMGSolver(a, AMGParams(tol=1e-8, verbose=False))
    x, info = solver.solve(b)
    assert info.rres < 1e-8
    # host-verified true residual
    import scipy.sparse as sp

    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    true_rres = np.linalg.norm(b - m @ x) / np.linalg.norm(b)
    assert true_rres < 5e-8


def test_unstructured_well_solve():
    """End-to-end solve through the WEll path (unstructured format):
    level 0 RCM-permuted (hh.perms[0] set, b/x handled at the API
    boundary), A/P/R packed as WEll, masked GS + FCG both converge, and
    the returned x is in the CALLER's ordering (host-verified residual
    must match the solver's internal one)."""
    import amg_tpu as amg
    from amg_tpu.sparse import WEll

    a = amg.fem2d(2500, seed=3)
    b = np.random.default_rng(1).standard_normal(a.n_rows)
    pars = AMGParams(tol=1e-8, verbose=False, use_well="on",
                     well_min_rows=512, dense_level_bytes=2e4,
                     use_banded="off", smoother=SmootherType.CHEBYSHEV,
                     accel="cg", refine=False)
    s = amg.AMGSolver(a, pars)
    assert isinstance(s.mg.levels[0].a, WEll)
    assert s._perm0 is not None  # RCM applied to level 0
    assert isinstance(s.mg.levels[0].p, WEll)  # transfers packed too
    x, info = s.solve(b)
    assert info.rres < 1e-8
    import scipy.sparse as sp

    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    true_rres = np.linalg.norm(b - m @ x) / np.linalg.norm(b)
    # true == internal residual proves the boundary permutation is exact
    # (absolute eps floor: with convergence-time residual replacement the
    # reported rres is itself a true residual; two true residuals from
    # different operators/summation orders differ ~1e-16 near eps)
    assert abs(true_rres - info.rres) < 1e-6 * info.rres + 1e-15


def test_unstructured_fem_graded_setup():
    """Graded-mesh variant: degree distribution is even more skewed; the
    format picker must not blow up ELL widths (hierarchy stays bounded)."""
    import amg_tpu as amg

    a = amg.fem2d(6000, seed=11, graded=True)
    hh = amg.setup_host(a, AMGParams(verbose=False))
    assert len(hh.a) >= 3
    # operator complexity stays sane on irregular meshes
    cmp_op = sum(m.nnz for m in hh.a) / hh.a[0].nnz
    assert cmp_op < 6.0


def test_poly_degree_schedule():
    """Per-level Chebyshev degree schedule: shallower degrees at depth must
    still converge; schedule is consumed per level (poly_deg_schedule)."""
    import amg_tpu as amg

    a = amg.poisson3d(16)
    b = np.ones(a.n_rows)
    base = AMGParams(tol=1e-8, verbose=False,
                     coarse_smoother=SmootherType.POLY)
    sched = base.replace(poly_deg_schedule=(3, 3, 2, 1))
    xs, info_s = amg.AMGSolver(a, sched).solve(b)
    xb, info_b = amg.AMGSolver(a, base).solve(b)
    assert info_s.rres < 1e-8 and info_b.rres < 1e-8
    # lighter deep smoothing may cost a few iterations, not blow up
    assert info_s.nits <= info_b.nits + 4


def test_transfer_op_dtype_bf16_converges():
    """bf16 P/R value planes on WEll levels (the 10M-row HBM-fit knob)
    still converge under the FCG wrap with an f64 outer iteration."""
    from amg_tpu.io.generators import fem2d
    from amg_tpu.sparse import WEll

    a = fem2d(20000, seed=17)
    b = np.random.default_rng(19).standard_normal(a.n_rows)
    pars = AMGParams(verbose=0, tol=1e-8, accel="cg", refine=True,
                     well_min_rows=1024, use_well="on",
                     transfer_op_dtype="bfloat16",
                     coarse_smoother=SmootherType.CHEBYSHEV, max_it=60)
    s = amg.AMGSolver(a, pars, log=lambda *x: None)
    import jax.numpy as jnp
    lv0 = s.mg.levels[0]
    assert isinstance(lv0.p, WEll) and lv0.p.vals.dtype == jnp.bfloat16
    x, info = s.solve(b)
    assert info.rres < 1e-8
    r = b - a.matvec(np.asarray(x, dtype=np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-7
