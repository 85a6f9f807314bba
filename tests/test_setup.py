"""Setup-phase tests: strength, C/F splitting, interpolation, RAP."""

import numpy as np
import pytest

import amg_tpu as amg
from amg_tpu.params import AMGParams, FGPT, CGPT, ISPT, InterpType
from amg_tpu.setup_phase.strength import strength_matrix
from amg_tpu.setup_phase.cf_split import rs_split, pmis_split, clean_ff_couplings
from amg_tpu.setup_phase.interp import build_interpolation, truncate, p_pattern_dir
from amg_tpu.ops.spgemm import rap, spgemm, spgemm_numpy
from amg_tpu.sparse import CSR


def _strength_bruteforce(a: CSR, eps=0.3, max_row_sum=0.9):
    """Row-by-row reimplementation of the reference rule (oracle)."""
    n = a.n_rows
    d = a.to_dense()
    s = np.zeros((n, n), dtype=bool)
    for i in range(n):
        row = d[i]
        row_sum = np.abs(row[row != 0]).sum()
        off = np.abs(np.delete(row, i))
        row_scl = eps * (off.max() if off.size else 0.0)
        if row_sum < (2 - max_row_sum) * abs(d[i, i]):
            continue
        for j in range(n):
            if j != i and row[j] != 0 and -row[j] > row_scl:
                s[i, j] = True
    return s


def test_strength_vs_bruteforce():
    a = amg.poisson2d(7)
    s = strength_matrix(a)
    oracle = _strength_bruteforce(a)
    got = s.to_dense() != 0
    np.testing.assert_array_equal(got, oracle)


def test_strength_anisotropic():
    # strong only in the x direction when eps-coupling is weak
    a = amg.poisson2d(6, epsilon=0.01)
    s = strength_matrix(a)
    d = s.to_dense()
    for i in range(36):
        for j in np.nonzero(d[i])[0]:
            assert abs(i - j) == 1, "only x-neighbors should be strong"


def test_strength_dominant_row():
    # a strongly diagonally dominant row has no strong couplings
    a = CSR.from_dense(np.array([[100.0, -1.0], [-1.0, 2.0]]))
    s = strength_matrix(a)
    assert s.row_degrees[0] == 0
    assert s.row_degrees[1] == 1


def _check_splitting_valid(s: CSR, vec):
    """Every F point with strong couplings interpolates from >=1 C point."""
    sp_, sj = s.indptr, s.indices
    for i in range(s.n_rows):
        if vec[i] == FGPT and sp_[i + 1] > sp_[i]:
            neigh = sj[sp_[i]: sp_[i + 1]]
            assert (vec[neigh] == CGPT).any() or (vec[neigh] == FGPT).any()


def test_rs_split_poisson():
    a = amg.poisson2d(16)
    s = strength_matrix(a)
    vec, col = rs_split(s)
    assert col == (vec == CGPT).sum()
    assert col > 0
    # 5-pt Poisson with theta=0.3: classical RS gives ~half the points coarse
    assert 0.3 < col / a.n_rows < 0.7
    _check_splitting_valid(s, vec)
    # no isolated points in a connected Poisson graph
    assert (vec == ISPT).sum() == 0


def test_rs_split_isolated_rows():
    # diagonal matrix: every point isolated
    a = CSR.from_dense(np.eye(12) * 3.0)
    s = strength_matrix(a)
    vec, col = rs_split(s)
    assert (vec == ISPT).all()
    assert col == 0


def test_c1_criterion_holds():
    """After RS splitting, strong F-F pairs share a C interpolatory point."""
    a = amg.poisson2d(12)
    s = strength_matrix(a)
    vec, col = rs_split(s)
    sp_, sj = s.indptr, s.indices
    for i in range(s.n_rows):
        if vec[i] != FGPT:
            continue
        ci = set(j for j in sj[sp_[i]: sp_[i + 1]] if vec[j] == CGPT)
        for j in sj[sp_[i]: sp_[i + 1]]:
            if vec[j] == FGPT:
                cj = set(k for k in sj[sp_[j]: sp_[j + 1]] if vec[k] == CGPT)
                assert ci & cj, f"F-F pair ({i},{j}) shares no C point"


def test_pmis_split_valid():
    a = amg.poisson2d(16)
    s = strength_matrix(a)
    vec, col = pmis_split(s)
    assert col == (vec == CGPT).sum() > 0
    # C points form an independent set in S
    sp_, sj = s.indptr, s.indices
    for i in range(s.n_rows):
        if vec[i] == CGPT:
            for j in sj[sp_[i]: sp_[i + 1]]:
                assert vec[j] != CGPT


def test_interp_dir_rows(bus1138=None):
    a = amg.poisson2d(10)
    pars = AMGParams()
    s = strength_matrix(a)
    vec, col = rs_split(s)
    col = clean_ff_couplings(s, vec, col)
    p = build_interpolation(a, s, vec, col, pars)
    assert p.n_cols == col
    # C rows are exact identity rows
    cidx = np.cumsum(vec == CGPT) - 1
    for i in np.flatnonzero(vec == CGPT):
        seg = slice(p.indptr[i], p.indptr[i + 1])
        assert p.indptr[i + 1] - p.indptr[i] == 1
        assert p.indices[seg][0] == cidx[i]
        assert p.data[seg][0] == 1.0
    # interpolation of constants: for a zero-row-sum interior F row,
    # P row sum == 1 (direct interpolation preserves constants there)
    rowsum_a = np.array([a.data[a.indptr[i]:a.indptr[i+1]].sum()
                         for i in range(a.n_rows)])
    rowsum_p = np.array([p.data[p.indptr[i]:p.indptr[i+1]].sum()
                         for i in range(p.n_rows)])
    interior_f = (np.abs(rowsum_a) < 1e-12) & (vec == FGPT)
    if interior_f.any():
        np.testing.assert_allclose(rowsum_p[interior_f], 1.0, rtol=1e-12)


def test_interp_std_runs():
    a = amg.poisson2d(10)
    pars = AMGParams(interp_type=InterpType.STD)
    s = strength_matrix(a)
    vec, col = rs_split(s)
    p = build_interpolation(a, s, vec, col, pars)
    assert p.n_cols == col
    assert p.nnz > 0
    # weights are finite
    assert np.isfinite(p.data).all()


def test_p_pattern_std_native_matches_python():
    """Native distance-2 STD pattern builder == the Python reference loop
    (exact, incl. first-visit column order) on structured + unstructured
    strength graphs."""
    from amg_tpu import native
    from amg_tpu.setup_phase.interp import p_pattern_std
    import amg_tpu.setup_phase.interp as interp_mod

    if native.lib is None:
        import pytest

        pytest.skip("native library unavailable")
    for a in (amg.poisson2d(24), amg.fem2d(1500, seed=9)):
        s = strength_matrix(a)
        vec, col = rs_split(s)
        got = native.lib.p_pattern_std(s, vec, col)
        # Python reference: call the module-level loop directly
        import numpy as _np

        n = s.n_rows
        want = None
        lib_save, native.lib = native.lib, None
        try:
            want = p_pattern_std(s, vec, col)
        finally:
            native.lib = lib_save
        _np.testing.assert_array_equal(got.indptr, want.indptr)
        _np.testing.assert_array_equal(got.indices, want.indices)


def test_sa_aggregate_native_matches_python():
    """Native three-phase aggregation == the Python greedy, exactly
    (same aggregate ids in the same order)."""
    from amg_tpu import native
    from amg_tpu.setup_phase.aggregation import aggregate

    if native.lib is None:
        import pytest

        pytest.skip("native library unavailable")
    for a in (amg.poisson2d(30), amg.fem2d(2000, seed=13)):
        s = strength_matrix(a)
        got, got_n = native.lib.sa_aggregate(s)
        lib_save, native.lib = native.lib, None
        try:
            want, want_n = aggregate(s)
        finally:
            native.lib = lib_save
        assert got_n == want_n
        np.testing.assert_array_equal(got, want)


def test_truncation_preserves_group_sums():
    # one row with mixed signs
    p = CSR.from_coo(
        [0, 0, 0, 0, 0], [0, 1, 2, 3, 4],
        [0.5, 0.04, -0.6, -0.05, 0.3], (1, 5),
    )
    t = truncate(p, 0.2)
    # small entries (0.04 vs max_pos*0.2=0.1; -0.05 vs min_neg*0.2=-0.12)
    # are dropped; group sums preserved
    d = t.to_dense()[0]
    assert d[1] == 0 and d[3] == 0
    np.testing.assert_allclose(d[d > 0].sum(), 0.84, rtol=1e-13)
    np.testing.assert_allclose(d[d < 0].sum(), -0.65, rtol=1e-13)


def test_truncation_zero_threshold_keeps_all():
    p = CSR.from_coo([0, 0], [0, 1], [0.5, -0.5], (1, 2))
    t = truncate(p, 0.0)
    assert t.nnz == 2
    np.testing.assert_allclose(t.to_dense(), p.to_dense())


def test_rap_matches_scipy():
    import scipy.sparse as sp

    a = amg.poisson2d(12)
    pars = AMGParams()
    s = strength_matrix(a)
    vec, col = rs_split(s)
    col = clean_ff_couplings(s, vec, col)
    p = build_interpolation(a, s, vec, col, pars)
    r = p.transpose()
    ac = rap(r, a, p)
    oracle = (r.to_scipy() @ a.to_scipy() @ p.to_scipy()).toarray()
    np.testing.assert_allclose(ac.to_dense(), oracle, rtol=1e-12, atol=1e-14)


def test_spgemm_numpy_oracle(rng):
    import scipy.sparse as sp

    x = sp.random(20, 30, density=0.2, random_state=np.random.RandomState(1),
                  format="csr")
    y = sp.random(30, 25, density=0.2, random_state=np.random.RandomState(2),
                  format="csr")
    a, b = CSR.from_scipy(x), CSR.from_scipy(y)
    c1 = spgemm_numpy(a, b)
    np.testing.assert_allclose(c1.to_dense(), (x @ y).toarray(),
                               rtol=1e-12, atol=1e-14)
    c2 = spgemm(a, b)
    np.testing.assert_allclose(c2.to_dense(), (x @ y).toarray(),
                               rtol=1e-12, atol=1e-14)


def test_hierarchy_coarsens_bus(bus1138):
    hh = amg.setup_host(bus1138, AMGParams(verbose=0))
    assert hh.num_levels >= 3
    sizes = [m.n_rows for m in hh.a]
    assert sizes[0] == 1138
    assert all(sizes[i] > sizes[i + 1] for i in range(len(sizes) - 1))
    grid, op = hh.complexity()
    assert 1.0 < grid < 3.0
    assert 1.0 < op < 5.0


def test_sa_aggregation_partitions():
    """Every non-isolated node lands in exactly one aggregate."""
    import amg_tpu as amg
    from amg_tpu.setup_phase.aggregation import aggregate
    from amg_tpu.setup_phase.strength import strength_matrix

    a = amg.poisson2d(20)
    s = strength_matrix(a, 0.25, 0.9)
    agg, n_agg = aggregate(s)
    assert n_agg > 0
    assert agg.min() >= 0  # no isolated nodes in a Poisson stencil
    assert agg.max() == n_agg - 1
    # aggregation should coarsen notably faster than 2:1
    assert n_agg <= a.n_rows // 3


def test_sa_interpolation_rowsums():
    """Smoothed P preserves the constant: P @ 1 ~ 1 away from boundary
    effects (the tentative P0 partitions unity; smoothing keeps row sums
    1 - omega*dinv*(A@1) which equals 1 on interior rows of a singular-free
    stencil only approximately — check P reproduces ones through P0)."""
    import amg_tpu as amg
    from amg_tpu.setup_phase.aggregation import (
        aggregate, tentative_p, sa_interpolation)
    from amg_tpu.setup_phase.strength import strength_matrix

    a = amg.poisson2d(16)
    s = strength_matrix(a, 0.25, 0.9)
    agg, n_agg = aggregate(s)
    p0 = tentative_p(agg, n_agg)
    ones_c = np.ones(n_agg)
    np.testing.assert_allclose(p0.matvec(ones_c), 1.0)
    p = sa_interpolation(a, agg, n_agg)
    assert p.shape == (a.n_rows, n_agg)
    # smoothed rows stay bounded and nonzero
    assert np.isfinite(p.data).all() and p.nnz >= p0.nnz


def test_sparsify_operator_rowsums_and_convergence():
    """Non-Galerkin sparsification preserves row sums exactly and keeps
    the hierarchy convergent."""
    import amg_tpu as amg
    from amg_tpu.hierarchy import sparsify_operator
    from amg_tpu.params import AMGParams, SmootherType

    a = amg.poisson3d(10)
    s = sparsify_operator(a, 0.3)
    np.testing.assert_allclose(
        s.to_dense().sum(axis=1), a.to_dense().sum(axis=1), atol=1e-12)
    assert s.nnz < a.nnz
    # diagonal untouched entries keep positions; matrix stays square CSR
    assert s.shape == a.shape

    big = amg.poisson3d(16)
    b = np.random.default_rng(4).standard_normal(big.n_rows)
    pars = AMGParams(verbose=0, tol=1e-8, accel="cg",
                     coarse_sparsify=0.01, sparsify_from_level=2,
                     coarse_smoother=SmootherType.CHEBYSHEV)
    solver = amg.AMGSolver(big, pars, log=lambda *x: None)
    x, info = solver.solve(b)
    r = np.linalg.norm(b - big.matvec(x)) / np.linalg.norm(b)
    assert r < 1e-8


def test_clip_to_band_lumps_rowsums():
    import amg_tpu as amg
    from amg_tpu.hierarchy import clip_to_band
    from amg_tpu.sparse import CSR

    rng = np.random.default_rng(3)
    n = 512
    # banded matrix plus a few far-off-band entries
    rows = np.arange(n)
    base = amg.poisson3d(8)  # bandwidth 64 -> block band 1
    far_r = rng.integers(0, n, 20)
    far_c = (far_r + 300) % n
    a = CSR.from_coo(
        np.concatenate([np.repeat(np.arange(n), np.diff(base.indptr)),
                        far_r]),
        np.concatenate([base.indices.astype(np.int64), far_c]),
        np.concatenate([base.data, rng.standard_normal(20)]),
        (n, n))
    c = clip_to_band(a, 1)
    rows_c = np.repeat(np.arange(n), np.diff(c.indptr))
    assert np.abs((c.indices.astype(np.int64) >> 7) - (rows_c >> 7)).max() <= 1
    np.testing.assert_allclose(c.to_dense().sum(axis=1),
                               a.to_dense().sum(axis=1), atol=1e-12)


def test_pmis_device_valid_splitting():
    """Device-resident PMIS (lax.while_loop + segment_max rounds) produces a
    valid PMIS partition: every point decided, C points independent in the
    undirected strong graph, every non-isolated F point has a strong C
    neighbor (in S union S^T)."""
    import amg_tpu as amg
    from amg_tpu.setup_phase.strength import strength_matrix
    from amg_tpu.setup_phase.cf_split import pmis_split_device
    from amg_tpu.params import UNPT, FGPT, CGPT

    for gen in (lambda: amg.poisson2d(24), lambda: amg.fem2d(1500, seed=5)):
        a = gen()
        s = strength_matrix(a)
        vec, col = pmis_split_device(s)
        n = s.n_rows
        assert col == (vec == CGPT).sum() > 0
        assert not (vec == UNPT).any()

        rows = s.row_indices
        cols = s.indices.astype(np.int64)
        # interpolation coverage: every F point with strong dependencies
        # has at least one C point among them (same guarantee the numpy
        # pmis_split provides; C-C adjacency across rounds is allowed in
        # PMIS — only same-round candidates are independent)
        covered = np.zeros(n, dtype=bool)
        covered[rows[vec[cols] == CGPT]] = True
        has_dep = s.row_degrees > 0
        f = vec == FGPT
        assert (covered[f & has_dep]).all()
        # matches the numpy implementation's coarse-fraction ballpark
        vec_np, col_np = __import__(
            "amg_tpu.setup_phase.cf_split", fromlist=["pmis_split"]
        ).pmis_split(s)
        assert 0.5 < col / max(col_np, 1) < 2.0
