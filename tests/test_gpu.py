"""Numerics that only a GPU can show.

These run with ``AMG_TEST_PLATFORM=cuda python -m pytest -m gpu`` on a
machine with an NVIDIA card (``chip_smoke.py`` runs them first) and skip
everywhere else.  Whether a card is present is decided in the ``gpu``
fixture, never at import.
"""

import numpy as np
import pytest

import amg_tpu as amg

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX's first device is "
                    f"{dev.platform})")
    return dev


def _rel(y, want):
    return float(np.max(np.abs(y - want)) / np.max(np.abs(want)))


def test_dense_f32_matvec_is_not_tf32(gpu):
    """A TF32 product keeps ~10 mantissa bits (~1e-3); the pinned
    HIGHEST precision keeps the f32 Dense level at f32 accuracy."""
    import jax
    import jax.numpy as jnp
    from amg_tpu.sparse import Dense
    from amg_tpu.ops.spmv import spmv

    rng = np.random.default_rng(0)
    n = 2048
    m = rng.standard_normal((n, n))
    d = Dense(jnp.asarray(m, dtype=jnp.float32), (n, n), n * n)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(jax.jit(spmv)(d, jnp.asarray(x)), dtype=np.float64)
    want = m.astype(np.float32).astype(np.float64) @ x.astype(np.float64)
    assert _rel(y, want) < 1e-5


def test_banded_f32_einsum_is_not_tf32(gpu):
    import jax
    import jax.numpy as jnp
    from amg_tpu.sparse import BandedBlocks
    from amg_tpu.ops.spmv import spmv

    a = amg.poisson2d(128)
    rng = np.random.default_rng(1)
    a.data[:] = rng.standard_normal(a.nnz)
    bb = BandedBlocks.from_csr(a, dtype=jnp.float32)
    x = np.zeros(bb.padded_rows, dtype=np.float32)
    x[: a.n_rows] = rng.standard_normal(a.n_rows)
    y = np.asarray(jax.jit(spmv)(bb, jnp.asarray(x)), dtype=np.float64)
    a32 = a.data.astype(np.float32).astype(np.float64)
    from amg_tpu.sparse import CSR

    want = CSR(a.indptr, a.indices, a32, a.shape).matvec(
        x[: a.n_rows].astype(np.float64))
    assert _rel(y[: a.n_rows], want) < 1e-5


def test_coarse_inverse_apply_is_not_tf32(gpu):
    """The dense coarse-inverse apply of the cycle, f32 on the card."""
    import jax
    import jax.numpy as jnp
    from amg_tpu.solve.cycle import coarsest_solve

    pars = amg.AMGParams(dtype="float32", verbose=0)
    mg, _ = amg.setup(amg.poisson2d(40), pars, log=lambda *a: None)
    inv = np.asarray(mg.coarse_inv, dtype=np.float64)
    b = np.random.default_rng(2).standard_normal(inv.shape[0])
    got = np.asarray(jax.jit(lambda m, v: coarsest_solve(m, v, pars, 1e-7))(
        mg, jnp.asarray(b, dtype=jnp.float32)), dtype=np.float64)
    want = inv @ b.astype(np.float32).astype(np.float64)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("fmt", ["dia", "ell", "well", "well_df64"])
def test_f64_formats_match_host(gpu, fmt):
    import jax
    import jax.numpy as jnp
    from amg_tpu.sparse import Dia, Ell, WEll
    from amg_tpu.ops.spmv import spmv

    a = amg.poisson3d(20) if fmt == "dia" else amg.fem2d(20000, seed=5)
    if fmt == "dia":
        op = Dia.from_csr(a, dtype=jnp.float64)
    elif fmt == "ell":
        op = Ell.from_csr(a, dtype=jnp.float64)
    elif fmt == "well":
        op = WEll.from_csr(a, dtype=jnp.float64)
    else:
        op = WEll.from_csr_df64(a)
    x = np.zeros(op.padded_rows)
    x[: a.n_rows] = np.random.default_rng(3).standard_normal(a.n_rows)
    y = np.asarray(jax.jit(spmv)(op, jnp.asarray(x)))[: a.n_rows]
    assert _rel(y, a.matvec(x[: a.n_rows])) < 1e-12


def test_mixed_precision_solve_reaches_1e8(gpu):
    """f32 cycles + f64 defect correction on the card: host-verified
    true relative residual below 1e-8."""
    from amg_tpu.params import SmootherType

    a = amg.poisson3d(32)
    # Chebyshev below level 0 and a 3500-row coarsest level, as bench.py
    # runs: masked GS on the dense coarse levels would unroll one matvec
    # per color (hundreds) and take minutes to compile
    pars = amg.AMGParams(dtype="float32", refine=True, tol=1e-8,
                         verbose=0, max_it=60, coarse_stop_rows=3500,
                         coarse_smoother=SmootherType.CHEBYSHEV)
    s = amg.AMGSolver(a, pars, log=lambda *x: None)
    b = np.ones(a.n_rows)
    x, info = s.solve(b)
    rres = np.linalg.norm(b - a.matvec(np.asarray(x, dtype=np.float64)))
    assert rres / np.linalg.norm(b) < 1e-8
