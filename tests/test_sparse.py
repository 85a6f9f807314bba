"""CSR / ELL container tests (vs scipy oracles)."""

import numpy as np
import pytest

import amg_tpu as amg
from amg_tpu.sparse import CSR, Ell


def _random_csr(rng, m=40, n=50, density=0.1):
    import scipy.sparse as sp

    a = sp.random(m, n, density=density, random_state=np.random.RandomState(0),
                  format="csr")
    a.data = rng.standard_normal(a.nnz)
    return a


def test_from_coo_dedup():
    a = CSR.from_coo([0, 0, 1], [1, 1, 0], [2.0, 3.0, 4.0], (2, 2))
    assert a.nnz == 2
    d = a.to_dense()
    assert d[0, 1] == 5.0 and d[1, 0] == 4.0


def test_transpose_matches_scipy(rng):
    s = _random_csr(rng)
    a = CSR.from_scipy(s)
    at = a.transpose()
    np.testing.assert_allclose(at.to_dense(), s.T.toarray(), atol=1e-14)


def test_matvec_matches_scipy(rng):
    s = _random_csr(rng)
    a = CSR.from_scipy(s)
    x = rng.standard_normal(a.n_cols)
    np.testing.assert_allclose(a.matvec(x), s @ x, rtol=1e-13)


def test_diagonal(rng):
    a = amg.poisson2d(8)
    np.testing.assert_allclose(a.diagonal_fast(), np.full(64, 4.0))
    np.testing.assert_allclose(a.diagonal(), a.diagonal_fast())


def test_ell_roundtrip(rng):
    s = _random_csr(rng, 33, 33, 0.15)
    a = CSR.from_scipy(s)
    e = Ell.from_csr(a)
    assert e.padded_rows % 8 == 0
    back = e.to_csr()
    np.testing.assert_allclose(back.to_dense(), a.to_dense(), atol=1e-14)


def test_ell_spmv(rng):
    from amg_tpu.ops.spmv import spmv, spmv_n, residual

    s = _random_csr(rng, 37, 41, 0.2)
    a = CSR.from_scipy(s)
    e = Ell.from_csr(a)
    x = rng.standard_normal(41)
    y = np.asarray(spmv(e, x))
    np.testing.assert_allclose(y[:37], s @ x, rtol=1e-12)
    assert np.all(y[37:] == 0)
    np.testing.assert_allclose(np.asarray(spmv_n(e, x)), s @ x, rtol=1e-12)
    b = rng.standard_normal(37)
    np.testing.assert_allclose(np.asarray(residual(e, x, b)), b - s @ x,
                               rtol=1e-12)


def test_ell_row_padding():
    a = amg.poisson2d(5)  # 25 rows
    e = Ell.from_csr(a, pad_rows_to=64)
    assert e.padded_rows == 64
    x = np.ones(25)
    from amg_tpu.ops.spmv import spmv

    y = np.asarray(spmv(e, x))
    np.testing.assert_allclose(y[:25], a.matvec(x), rtol=1e-13)
    assert np.all(y[25:] == 0)


def test_dia_roundtrip():
    from amg_tpu.sparse import Dia

    a = amg.poisson2d(9)
    d = Dia.from_csr(a)
    assert d.n_diags == 5
    np.testing.assert_allclose(d.to_csr().to_dense(), a.to_dense())


def test_dia_spmv_matches_csr(rng):
    from amg_tpu.sparse import Dia
    from amg_tpu.ops.spmv import spmv

    a = amg.poisson2d(11)
    d = Dia.from_csr(a)
    x = np.zeros(d.padded_rows)
    x[: a.n_rows] = rng.standard_normal(a.n_rows)
    import jax.numpy as jnp

    y = np.asarray(spmv(d, jnp.asarray(x)))
    np.testing.assert_allclose(y[: a.n_rows], a.matvec(x[: a.n_rows]),
                               rtol=1e-13)
    assert np.all(y[a.n_rows:] == 0)


def test_dia_num_offsets():
    from amg_tpu.sparse import Dia

    a = amg.poisson3d(5)
    assert Dia.num_offsets(a) == 7












def test_banded_blocks_matches_csr():
    """BandedBlocks SpMV == host CSR matvec, round-trip preserved."""
    import jax.numpy as jnp
    import amg_tpu as amg
    from amg_tpu.sparse import BandedBlocks
    from amg_tpu.ops.spmv import spmv

    a = amg.poisson3d(8)  # n=512, bandwidth 64 -> nb=1
    bb = BandedBlocks.from_csr(a, dtype=jnp.float64)
    assert bb.nb >= 1 and bb.padded_rows % 128 == 0
    rng_ = np.random.default_rng(7)
    x = rng_.standard_normal(bb.padded_rows)
    x[a.n_rows:] = 0.0
    y = np.asarray(spmv(bb, jnp.asarray(x)))
    want = a.matvec(x[: a.n_rows])
    np.testing.assert_allclose(y[: a.n_rows], want, rtol=1e-13, atol=1e-13)
    assert y[a.n_rows:].size == 0 or np.abs(y[a.n_rows:]).max() == 0.0
    np.testing.assert_allclose(bb.to_csr().to_dense(), a.to_dense())




def test_blas1_matches_numpy(rng):
    """BLAS-1 surface (reference SSS_blas_array_*, amg/SSS_utils.c:151-260)."""
    import jax.numpy as jnp
    from amg_tpu.ops.blas import dot, norm2, norminf, axpy, axpby

    x = rng.standard_normal(97)
    y = rng.standard_normal(97)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(float(dot(jx, jy)), x @ y, rtol=1e-12)
    np.testing.assert_allclose(float(norm2(jx)), np.linalg.norm(x), rtol=1e-12)
    np.testing.assert_allclose(float(norminf(jx)), np.abs(x).max(), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(axpy(0.7, jx, jy)), 0.7 * x + y,
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(axpby(0.3, jx, -1.2, jy)),
                               0.3 * x - 1.2 * y, rtol=1e-12)


def test_well_roundtrip_and_spmv(rng):
    """WEll packing invariants + SpMV vs scipy on an unstructured matrix
    (the unstructured answer to the reference's general CSR SpMV,
    amg/SSS_utils.c:182-201)."""
    import jax.numpy as jnp
    from amg_tpu.io.generators import fem2d
    from amg_tpu.sparse import WEll
    from amg_tpu.ops.spmv import spmv

    a = fem2d(3000, seed=1)
    # f64 pack: the roundtrip is exact
    w64 = WEll.from_csr(a, dtype=jnp.float64)
    back = w64.to_csr()
    diff = (a.to_scipy() - back.to_scipy()).tocoo()
    diff.eliminate_zeros()
    assert diff.nnz == 0

    w = WEll.from_csr(a, dtype=jnp.float32)

    # packing invariants: remainders in [0,128), Q blocks in [0,8),
    # windows inside the padded x; int16 storage of (Q << 7) | r
    loc = np.asarray(w.loc)
    assert loc.dtype == np.int16
    loc = loc.astype(np.int32)
    base = np.asarray(w.base)
    assert ((loc & 127) < 128).all() and (loc >= 0).all()
    assert (loc >> 7 < 8).all()
    assert base.min() >= 0
    assert (128 * base.max() + 1024) <= w.pad_cols

    x = rng.standard_normal(a.n_cols).astype(np.float32)
    y = np.asarray(spmv(w, jnp.asarray(x)))[: a.n_rows]
    want = a.to_scipy() @ x
    np.testing.assert_allclose(y, want, rtol=2e-4, atol=2e-4)


def test_well_rectangular(rng):
    """WEll on a rectangular operator (P/R shapes)."""
    import jax.numpy as jnp
    from amg_tpu.sparse import WEll
    from amg_tpu.ops.spmv import spmv

    a = CSR.from_scipy(_random_csr(rng, m=1500, n=700, density=0.01))
    w = WEll.from_csr(a, dtype=jnp.float32)
    x = rng.standard_normal(a.n_cols).astype(np.float32)
    y = np.asarray(spmv(w, jnp.asarray(x)))[: a.n_rows]
    want = a.to_scipy() @ x
    np.testing.assert_allclose(y, want, rtol=2e-4, atol=2e-4)


def test_well_df64_spmv(rng):
    """The double-single (df64) WEll split pack reproduces the f64
    operator: split-pack roundtrip is ~exact and the apply matches scipy
    f64 to ~1e-13 — far beyond f32's ~1e-6 (this backs the
    mixed-precision outer loop on unstructured levels)."""
    import jax.numpy as jnp
    from amg_tpu.io.generators import fem2d
    from amg_tpu.sparse import WEll
    from amg_tpu.ops.spmv import spmv

    a = fem2d(3000, seed=4)
    w = WEll.from_csr_df64(a)
    # split reproduces the f64 operator to double-single precision:
    # 24+24 = 48 mantissa bits, so ~2^-48 RELATIVE error is the exact
    # representation floor (the old absolute-1e-15 bound was a dead
    # assertion — an operator precedence bug kept it from running; once
    # fixed it failed, correctly, on the 1e3-conductivity entries)
    back = w.to_csr().to_scipy() - a.to_scipy()
    scale = np.abs(a.data).max()
    rel = (np.abs(back.data).max() / scale) if back.nnz else 0.0
    assert rel < 1e-13, rel

    x = rng.standard_normal(a.n_cols)
    want = a.to_scipy() @ x
    scale = np.abs(want).max()

    y_fb = np.asarray(spmv(w, jnp.asarray(x)))[: a.n_rows]
    assert np.abs(y_fb - want).max() / scale < 1e-13

    # and the f32 path on the same operator is ~1e-6 (sanity that
    # the df64 machinery is actually buying precision)
    w32 = WEll.from_csr(a, dtype=jnp.float32)
    y32 = np.asarray(spmv(w32, jnp.asarray(x.astype(np.float32))))
    assert np.abs(y32[: a.n_rows] - want).max() / scale > 1e-9





