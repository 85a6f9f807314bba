"""Multi-device tests on the emulated 8-device CPU mesh."""

import numpy as np
import pytest
import jax

import amg_tpu as amg
from amg_tpu.params import AMGParams, SmootherType
from amg_tpu.parallel import make_mesh, shard_hierarchy, shard_vector, DistAMGSolver


requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >=2 devices"
)


@requires_multidevice
def test_mesh_creation():
    mesh = make_mesh(4)
    assert mesh.shape["x"] == 4


@requires_multidevice
def test_sharded_spmv_matches_single():
    import jax.numpy as jnp
    from amg_tpu.sparse import Ell
    from amg_tpu.ops.spmv import spmv

    a = amg.poisson2d(32)
    mesh = make_mesh(8)
    e = Ell.from_csr(a)
    x = np.random.default_rng(0).standard_normal(e.padded_rows)

    y_single = np.asarray(spmv(e, jnp.asarray(x)))

    from amg_tpu.parallel.dist import _pad_rows_multiple, _row_sharding

    es = _pad_rows_multiple(e, 8)
    es = Ell(
        jax.device_put(es.cols, _row_sharding(mesh, 2)),
        jax.device_put(es.vals, _row_sharding(mesh, 2)),
        es.shape, es.nnz,
    )
    xs = shard_vector(x, mesh)
    y_dist = np.asarray(jax.jit(spmv)(es, xs))
    np.testing.assert_allclose(y_dist[: len(y_single)], y_single, rtol=1e-12)


@requires_multidevice
def test_dist_solver_matches_single_chip():
    a = amg.poisson2d(24)
    pars = AMGParams(verbose=0, smoother=SmootherType.L1DIAG)
    b = np.ones(a.n_rows)

    x1, info1 = amg.AMGSolver(a, pars).solve(b)
    mesh = make_mesh(4)
    x2, info2 = DistAMGSolver(a, pars, mesh=mesh, log=lambda *a: None).solve(b)

    assert info2.rres < 1e-6
    assert abs(info1.nits - info2.nits) <= 1
    np.testing.assert_allclose(x1, x2, rtol=1e-8, atol=1e-10)


@requires_multidevice
def test_dist_solver_gs_converges():
    """GS smoothing under GSPMD sharding still converges identically."""
    a = amg.poisson2d(24)
    pars = AMGParams(verbose=0)
    b = np.ones(a.n_rows)
    x1, info1 = amg.AMGSolver(a, pars).solve(b)
    x2, info2 = DistAMGSolver(a, pars, mesh=make_mesh(8),
                              log=lambda *a: None).solve(b)
    assert info2.rres < 1e-6
    assert info1.nits == info2.nits
    np.testing.assert_allclose(x1, x2, rtol=1e-8, atol=1e-10)


@requires_multidevice
def test_dist_cg_psum():
    """CG on a sharded operator (auto-psum dots) matches dense solve."""
    import jax.numpy as jnp
    from amg_tpu.sparse import Ell
    from amg_tpu.solve.krylov import cg
    from amg_tpu.parallel.dist import _pad_rows_multiple, _row_sharding

    a = amg.poisson2d(16)
    mesh = make_mesh(8)
    e = _pad_rows_multiple(Ell.from_csr(a), 8)
    es = Ell(
        jax.device_put(e.cols, _row_sharding(mesh, 2)),
        jax.device_put(e.vals, _row_sharding(mesh, 2)),
        e.shape, e.nnz,
    )
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(a.n_rows)
    b = np.zeros(e.padded_rows)
    b[: a.n_rows] = a.matvec(x_true)
    bs = shard_vector(b, mesh)
    x, conv = jax.jit(lambda e, b: cg(e, b, jnp.zeros_like(b), tol=1e-10,
                                      maxit=800))(es, bs)
    assert bool(conv)
    np.testing.assert_allclose(np.asarray(x)[: a.n_rows], x_true,
                               rtol=1e-6, atol=1e-7)


@requires_multidevice
def test_dist_refine_matches_single():
    """Sharded defect correction reaches the same tolerance as single-chip."""
    from amg_tpu.params import SmootherType

    a = amg.poisson3d(10)
    b = np.random.default_rng(4).standard_normal(a.n_rows)
    pars = AMGParams(tol=1e-10, dtype="float32", refine=True, verbose=0,
                     coarse_smoother=SmootherType.CHEBYSHEV)
    s1 = amg.AMGSolver(a, pars, log=lambda *x: None)
    x1, i1 = s1.solve(b)
    s2 = DistAMGSolver(a, pars, mesh=make_mesh(8), log=lambda *x: None)
    assert s2.a0_hi is not None
    x2, i2 = s2.solve(b)
    r2 = b - a.matvec(x2)
    assert np.linalg.norm(r2) / np.linalg.norm(b) < 1e-10
    assert i1.nits == i2.nits


def test_ring_halo_spmv_matches_global():
    """shard_map ring-halo DIA SpMV == single-device SpMV on the 8-device
    CPU mesh, including the zero boundary (no wrap-around)."""
    import jax
    import jax.numpy as jnp
    import amg_tpu as amg
    from amg_tpu.sparse import Dia
    from amg_tpu.ops.spmv import spmv
    from amg_tpu.parallel import make_mesh
    from amg_tpu.parallel.halo import spmv_dia_ring

    a = amg.poisson3d(8)  # 512 rows, offsets up to +/-64
    ndev = 8
    pad = ((a.n_rows + ndev * 8 - 1) // (ndev * 8)) * (ndev * 8)
    d = Dia.from_csr(a, dtype=jnp.float64, pad_rows_to=pad)
    rng_ = np.random.default_rng(5)
    x = jnp.asarray(np.pad(rng_.standard_normal(a.n_rows),
                           (0, pad - a.n_rows)))
    y_ref = np.asarray(spmv(d, x))[:a.n_rows]
    mesh = make_mesh(ndev)
    y = np.asarray(spmv_dia_ring(d, x, mesh))[:a.n_rows]
    np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-14)


def test_ring_halo_wide_band_multihop():
    """Bands wider than the shard block use multi-hop halos and still
    match the global product."""
    import jax.numpy as jnp
    import amg_tpu as amg
    from amg_tpu.sparse import Dia
    from amg_tpu.ops.spmv import spmv
    from amg_tpu.parallel import make_mesh
    from amg_tpu.parallel.halo import spmv_dia_ring

    a = amg.poisson2d(4)  # 16 rows, offsets +/-4, blocks of 2 < 4
    d = Dia.from_csr(a, dtype=jnp.float64, pad_rows_to=16)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(16))
    y = np.asarray(spmv_dia_ring(d, x, make_mesh(8)))
    want = np.asarray(spmv(d, x))
    np.testing.assert_allclose(y, want, rtol=1e-13, atol=1e-14)


def test_spmd_cycle_matches_single_device():
    """The hand-placed shard_map cycle reproduces the single-device solve
    (same iterations, same solution) on the emulated 8-device mesh."""
    import jax.numpy as jnp
    import amg_tpu as amg
    from amg_tpu.params import AMGParams, SmootherType
    from amg_tpu.parallel import make_mesh
    from amg_tpu.parallel.spmd_cycle import SpmdAMGSolver

    a = amg.poisson3d(16)  # 4096 rows, embeds on a banded level-0
    b = np.random.default_rng(29).standard_normal(a.n_rows)
    pars = AMGParams(verbose=0, tol=1e-8, embed_levels=8,
                     coarse_smoother=SmootherType.CHEBYSHEV)
    ref = amg.AMGSolver(a, pars, log=lambda *x: None)
    x1, i1 = ref.solve(b)

    mesh = make_mesh(8)
    s = SpmdAMGSolver(a, pars, mesh=mesh, log=lambda *x: None)
    assert s.E >= 1
    x2, i2 = s.solve(b)
    assert i2.rres < 1e-8
    assert abs(i1.nits - i2.nits) <= 1
    np.testing.assert_allclose(x2, x1, rtol=1e-8, atol=1e-10)


def test_spmd_fcg_matches_single_device():
    """The distributed FCG wrap (psum dots, sharded V-cycle
    preconditioner, f64 outer vs the exact sharded operator) matches the
    single-device solve_pcg on the emulated 8-device mesh — the robust
    mode the 10M-row sparsified recipe needs (VERDICT r3 item 3)."""
    import amg_tpu as amg
    from amg_tpu.params import AMGParams, SmootherType
    from amg_tpu.parallel import make_mesh
    from amg_tpu.parallel.spmd_cycle import SpmdAMGSolver

    a = amg.poisson3d(16)
    b = np.random.default_rng(31).standard_normal(a.n_rows)
    pars = AMGParams(verbose=0, tol=1e-10, embed_levels=8, accel="cg",
                     refine=True, coarse_sparsify=0.005,
                     sparsify_from_level=2,
                     coarse_smoother=SmootherType.CHEBYSHEV)
    ref = amg.AMGSolver(a, pars, log=lambda *x: None)
    x1, i1 = ref.solve(b)

    s = SpmdAMGSolver(a, pars, mesh=make_mesh(8), log=lambda *x: None)
    x2, i2 = s.solve(b)  # dispatches to solve_pcg
    assert i2.rres < 1e-10
    assert abs(i1.nits - i2.nits) <= 1
    # f64 outer: both converge to the same solution to outer precision
    np.testing.assert_allclose(x2, x1, rtol=1e-9, atol=1e-12)
    r = b - a.matvec(np.asarray(x2, dtype=np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-9


def test_spmd_cycle_chebyshev_everywhere():
    """shard_map cycle with Chebyshev on level 0 too (no GS masks)."""
    import amg_tpu as amg
    from amg_tpu.params import AMGParams, SmootherType
    from amg_tpu.parallel import make_mesh
    from amg_tpu.parallel.spmd_cycle import SpmdAMGSolver

    a = amg.poisson2d(32)
    b = np.ones(a.n_rows)
    pars = AMGParams(verbose=0, smoother=SmootherType.CHEBYSHEV,
                     max_it=60)
    s = SpmdAMGSolver(a, pars, mesh=make_mesh(4), log=lambda *x: None)
    x, info = s.solve(b)
    assert info.rres < 1e-6
    r = b - a.matvec(np.asarray(x, dtype=np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6


@requires_multidevice
@pytest.mark.slow
@pytest.mark.parametrize("sm", [
    SmootherType.SGS, SmootherType.SSOR, SmootherType.GSOR,
    SmootherType.SGSOR, SmootherType.CG,
])
def test_spmd_smoother_surface_full_solve(sm):
    """Full shard_map solves with every symmetric/relaxed/Krylov smoother
    reproduce the single-device solve (slow: each compiles a full
    distributed cycle on the emulated mesh)."""
    import amg_tpu as amg
    from amg_tpu.parallel import make_mesh
    from amg_tpu.parallel.spmd_cycle import SpmdAMGSolver

    a = amg.poisson3d(12)
    b = np.random.default_rng(37).standard_normal(a.n_rows)
    pars = AMGParams(verbose=0, tol=1e-8, embed_levels=8, relax=0.9,
                     smoother=sm, max_it=80,
                     coarse_smoother=SmootherType.CHEBYSHEV)
    ref = amg.AMGSolver(a, pars, log=lambda *x: None)
    x1, i1 = ref.solve(b)

    s = SpmdAMGSolver(a, pars, mesh=make_mesh(4), log=lambda *x: None)
    x2, i2 = s.solve(b)
    assert i2.rres < 1e-8
    assert abs(i1.nits - i2.nits) <= 1
    np.testing.assert_allclose(x2, x1, rtol=1e-6, atol=1e-8)


@requires_multidevice
@pytest.mark.parametrize("sm", [
    SmootherType.SGS, SmootherType.SSOR, SmootherType.GSOR,
    SmootherType.SGSOR, SmootherType.CG,
])
def test_spmd_smoother_matches_single_device(sm):
    """_smooth_local under shard_map == solve.smoothers.smooth for every
    SmootherType (VERDICT r4 item 7: the distributed path must not
    silently narrow the smoother surface).  Compiles only the smoother,
    not the whole cycle, so it stays in the default suite."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    import amg_tpu as amg
    from amg_tpu.hierarchy import setup
    from amg_tpu.parallel import make_mesh, shard_hierarchy
    from amg_tpu.parallel.spmd_cycle import (_smooth_local, _level_specs,
                                             num_embedded)
    from amg_tpu.solve.smoothers import smooth

    a = amg.poisson3d(12)
    pars = AMGParams(verbose=0, embed_levels=8, relax=0.9, smoother=sm)
    mg, _ = setup(a, pars, log=lambda *x: None)
    assert num_embedded(mg) >= 1
    mesh = make_mesh(4)
    axis = mesh.axis_names[0]
    smg = shard_hierarchy(mg, mesh, pars, replicate_from_level=1)
    lvl, slvl = mg.levels[0], smg.levels[0]
    pad = lvl.pad
    rng = np.random.default_rng(41)
    x0 = jnp.asarray(rng.standard_normal(pad))
    b0 = jnp.asarray(rng.standard_normal(pad))

    want = np.asarray(smooth(lvl, x0, b0, pars, 2, pre=True))

    fn = shard_map(
        lambda l, x, b: _smooth_local(l, x, b, pars, 2, True, axis, 4),
        mesh=mesh,
        in_specs=(_level_specs(slvl, True, axis), P(axis), P(axis)),
        out_specs=P(axis), check_vma=False)
    got = np.asarray(fn(slvl, x0, b0))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)


@requires_multidevice
def test_well_ring_spmv_matches_global():
    """Groups-sharded WEll ring SpMV == global WEll SpMV on the emulated
    mesh (the unstructured format must not turn itself off when a second
    device appears)."""
    import jax.numpy as jnp
    from amg_tpu.io.generators import fem2d
    from amg_tpu.sparse import WEll
    from amg_tpu.ops.spmv import spmv
    from amg_tpu.parallel.halo import spmv_well_ring, well_shard_plan
    from amg_tpu.hierarchy import reorder_l0_for_well  # noqa: F401

    a = fem2d(6000, seed=7)
    # bandwidth-reduce like the production pack (windows hug the diagonal)
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    perm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                      dtype=np.int64)
    a = a.permute(perm)

    w = WEll.from_csr(a, dtype=jnp.float32, pad_rows_to=8 * 1024)
    lo, hi = well_shard_plan(w, 4)
    assert lo + hi < 4 * w.padded_rows // 128  # halos thinner than the mesh

    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        w.pad_cols).astype(np.float32))
    want = np.asarray(spmv(w, x))[: w.padded_rows]

    mesh = make_mesh(4)
    got = np.asarray(spmv_well_ring(w, x, mesh))
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


@requires_multidevice
def test_banded_ring_spmv_matches_global():
    """Block-row-sharded BandedBlocks ring SpMV == global spmv_banded on
    the emulated mesh."""
    import jax.numpy as jnp
    import amg_tpu as amg
    from amg_tpu.sparse import BandedBlocks
    from amg_tpu.ops.spmv import spmv_banded
    from amg_tpu.parallel.halo import spmv_banded_ring

    a = amg.poisson2d(32)  # 1024 rows -> 8 blocks of 128, nb = 1
    b = BandedBlocks.from_csr(a, dtype=jnp.float32)
    assert b.vals.shape[0] % 8 == 0
    x = jnp.asarray(np.random.default_rng(5).standard_normal(
        b.padded_rows).astype(np.float32))
    want = np.asarray(spmv_banded(b, x))
    got = np.asarray(spmv_banded_ring(b, x, make_mesh(8)))
    scale = max(np.abs(want).max(), 1e-30)
    # both einsums pin HIGHEST precision: f32 tolerance on every backend
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


@requires_multidevice
def test_spmd_general_unstructured_solve():
    """The general sharded cycle solves an UNSTRUCTURED problem with
    row-sharded WEll levels and real ring P/R transfers on the emulated
    mesh, matching the single-chip solver with the same (ring-aware)
    packing (VERDICT r4 item 4: distributed unstructured must not
    degrade to gather-ELL/replication)."""
    from amg_tpu.io.generators import fem2d
    from amg_tpu.parallel.spmd_cycle import SpmdAMGSolver
    from amg_tpu.sparse import WEll

    a = fem2d(20000, seed=11)
    b = np.random.default_rng(13).standard_normal(a.n_rows)
    pars = AMGParams(verbose=0, tol=1e-8, accel="cg", refine=True,
                     well_min_rows=1024, dist_devices=4,
                     coarse_smoother=SmootherType.CHEBYSHEV)
    ref = amg.AMGSolver(a, pars, log=lambda *x: None)
    x1, i1 = ref.solve(b)

    s = SpmdAMGSolver(a, pars, mesh=make_mesh(4), log=lambda *x: None)
    assert s.E == 0 and s.Es >= 1          # general mode, >=2 sharded levels
    assert isinstance(s.mg.levels[0].a, WEll)
    assert s.mg.levels[0].a.ring_plan is not None
    x2, i2 = s.solve(b)
    assert i2.rres < 1e-8
    r = b - a.matvec(np.asarray(x2, dtype=np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-7
    assert abs(i1.nits - i2.nits) <= 2
    np.testing.assert_allclose(x2, x1, rtol=1e-5, atol=1e-7)


@requires_multidevice
def test_well_ring_with_packed_ring_plan():
    """spmv_well_ring accepts an operator packed WITH a precomputed
    ring_plan (regression: the shard_map spec pytree omitted the plan
    from its aux metadata and crashed on exactly the ring-aware packs
    the wrapper serves)."""
    import jax.numpy as jnp
    from amg_tpu.io.generators import fem2d
    from amg_tpu.sparse import WEll
    from amg_tpu.ops.spmv import spmv
    from amg_tpu.parallel.halo import spmv_well_ring

    a = fem2d(6000, seed=7)
    w = WEll.from_csr(a, dtype=jnp.float32, pad_rows_to=8 * 1024,
                      pad_cols_to=8 * 1024, ring_devices=4)
    assert w.ring_plan is not None
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        w.pad_cols).astype(np.float32))
    want = np.asarray(spmv(w, x))[: w.padded_rows]
    got = np.asarray(spmv_well_ring(w, x, make_mesh(4)))
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)
