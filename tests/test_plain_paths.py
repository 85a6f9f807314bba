"""The plain XLA paths every format runs, and the rules around them.

Each sparse product is checked against the host f64 CSR product; the
matrix products that XLA may hand to tensor cores are checked for their
pinned precision; the compile-cache, embedding and device rules are
checked as the GPU run relies on them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import amg_tpu as amg
from amg_tpu.sparse import CSR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _banded(n, n_diags, seed):
    """Random banded CSR with ``n_diags`` distinct offsets (the main
    diagonal among them)."""
    rng = np.random.default_rng(seed)
    offs = rng.choice(np.arange(-3 * n_diags, 3 * n_diags + 1),
                      size=n_diags - 1, replace=False)
    offs = np.unique(np.concatenate([[0], offs[offs != 0]]))
    if len(offs) < n_diags:
        extra = np.setdiff1d(np.arange(-4 * n_diags, 4 * n_diags + 1), offs)
        offs = np.sort(np.concatenate([offs, extra[: n_diags - len(offs)]]))
    rows_l, cols_l, vals_l = [], [], []
    for o in offs:
        i = np.arange(max(0, -o), min(n, n - o))
        rows_l.append(i)
        cols_l.append(i + o)
        vals_l.append(rng.standard_normal(len(i)))
    return CSR.from_coo(np.concatenate(rows_l), np.concatenate(cols_l),
                        np.concatenate(vals_l), (n, n))


def _rel(y, want):
    return float(np.max(np.abs(np.asarray(y, np.float64) - want))
                 / np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_diags", [7, 40, 600],
                         ids=["7-stencil", "40-band", "600-band-scan"])
def test_spmv_dia_matches_host(n_diags, dtype):
    """Plain shifted-slice Dia SpMV == host CSR, for an unrolled stencil,
    a wide unrolled band and a >512-diagonal band (the lax.scan path)."""
    import jax
    import jax.numpy as jnp
    from amg_tpu.sparse import Dia
    from amg_tpu.ops.spmv import spmv_dia

    a = amg.poisson3d(12) if n_diags == 7 else _banded(3000, n_diags, 1)
    d = Dia.from_csr(a, dtype=jnp.dtype(dtype))
    assert len(d.offsets) == n_diags
    x = np.zeros(d.padded_rows, dtype=dtype)
    x[: a.n_rows] = np.random.default_rng(2).standard_normal(a.n_rows)
    y = np.asarray(jax.jit(spmv_dia)(d, jnp.asarray(x)))
    err = _rel(y[: a.n_rows], a.matvec(x[: a.n_rows].astype(np.float64)))
    assert err < (1e-5 if dtype == "float32" else 1e-13)
    assert np.all(y[a.n_rows:] == 0)


def _dia_level(seed=0):
    import jax.numpy as jnp
    from amg_tpu.sparse import Dia

    a = amg.poisson3d(10)
    d = Dia.from_csr(a, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    pad = d.padded_rows
    x = rng.standard_normal(pad)
    b = rng.standard_normal(pad)
    x[a.n_rows:] = 0.0
    b[a.n_rows:] = 0.0
    return a, d, x, b


def test_residual_matches_numpy():
    import jax.numpy as jnp
    from amg_tpu.ops.spmv import residual

    a, d, x, b = _dia_level(3)
    r = np.asarray(residual(d, jnp.asarray(x), jnp.asarray(b)))
    want = b[: a.n_rows] - a.matvec(x[: a.n_rows])
    np.testing.assert_allclose(r[: a.n_rows], want, rtol=1e-12, atol=1e-12)


def test_masked_gs_update_matches_numpy():
    """One masked Gauss-Seidel group update (the Dia/Dense/WEll smoother
    path) == its numpy formula: rows of group g take
    (b - Ax + a_ii x) / a_ii, every other row keeps x."""
    import types
    import jax.numpy as jnp
    from amg_tpu.solve.smoothers import _masked_group_update

    a, d, x, b = _dia_level(4)
    pad = d.padded_rows
    diag = np.zeros(pad)
    diag[: a.n_rows] = a.diagonal_fast()
    inv = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 0.0)
    gid = (np.arange(pad) % 3).astype(np.int32)
    lvl = types.SimpleNamespace(a=d, diag=jnp.asarray(diag),
                                inv_diag=jnp.asarray(inv),
                                gid=jnp.asarray(gid))
    got = np.asarray(_masked_group_update(lvl, jnp.asarray(x),
                                          jnp.asarray(b), 1))
    ax = np.zeros(pad)
    ax[: a.n_rows] = a.matvec(x[: a.n_rows])
    t = (b - ax + diag * x) * inv
    want = np.where((gid == 1) & (inv != 0), t, x)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fmt", ["dia", "ell", "well"])
def test_vmap_spmv_over_four_rhs(fmt):
    """jax.vmap of the plain SpMV over 4 right-hand sides (the batched
    solver's SpMM) == the per-column products."""
    import jax
    import jax.numpy as jnp
    from amg_tpu.sparse import Dia, Ell, WEll
    from amg_tpu.ops.spmv import spmv

    if fmt == "dia":
        a = amg.poisson3d(10)
        op = Dia.from_csr(a, dtype=jnp.float64)
    else:
        a = amg.fem2d(2000, seed=6)
        op = (Ell if fmt == "ell" else WEll).from_csr(a, dtype=jnp.float64)
    xs = np.zeros((4, op.padded_rows))
    xs[:, : a.n_rows] = np.random.default_rng(5).standard_normal(
        (4, a.n_rows))
    ys = np.asarray(jax.vmap(lambda v: spmv(op, v))(jnp.asarray(xs)))
    for j in range(4):
        np.testing.assert_allclose(ys[j, : a.n_rows],
                                   a.matvec(xs[j, : a.n_rows]),
                                   rtol=1e-12, atol=1e-12)


def _dot_generals(jaxpr):
    """Every dot_general equation in a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for s in subs:
                inner = getattr(s, "jaxpr", s)   # ClosedJaxpr -> Jaxpr
                if hasattr(inner, "eqns"):
                    out += _dot_generals(inner)
    return out


def _site(name):
    """(function, example args) for each pinned matrix-product site."""
    import jax.numpy as jnp
    from amg_tpu.ops import spmv as sp
    from amg_tpu.ops.blas import dot, norm2
    from amg_tpu.sparse import Dense, BandedBlocks
    from amg_tpu.solve.cycle import coarsest_solve
    from amg_tpu.solve.smoothers import _range_update_dense
    from amg_tpu.solve.krylov import gmres
    import types

    v = jnp.ones(256, jnp.float32)
    dense = Dense(jnp.ones((256, 256), jnp.float32), (256, 256), 256 * 256)
    if name == "spmv_dense":
        return sp.spmv_dense, (dense, v)
    if name == "spmv_banded":
        bb = BandedBlocks.from_csr(amg.poisson2d(16), dtype=jnp.float32)
        return sp.spmv_banded, (bb, v)
    if name == "banded_ring":
        from amg_tpu.parallel import make_mesh
        from amg_tpu.parallel.halo import spmv_banded_ring

        bb = BandedBlocks.from_csr(amg.poisson2d(16), dtype=jnp.float32)
        mesh = make_mesh(2)
        return (lambda b_, x_: spmv_banded_ring(b_, x_, mesh)), (bb, v)
    if name == "coarsest_solve":
        pars = amg.AMGParams(dtype="float32")
        mg = types.SimpleNamespace(coarse_inv=dense.vals)
        return (lambda b_: coarsest_solve(mg, b_, pars, 1e-7)), (v,)
    if name == "range_update_dense":
        lvl = types.SimpleNamespace(a=dense, diag=v, inv_diag=v)
        return (lambda x_, b_: _range_update_dense(lvl, x_, b_, 0, 128)), \
            (v, v)
    if name == "blas_dot_norm2":
        return (lambda x_, y_: dot(x_, y_) + norm2(x_)), (v, v)
    if name == "gmres":
        return (lambda b_: gmres(dense, b_, jnp.zeros_like(b_), tol=1e-6,
                                 maxit=4, restart=4)[0]), (v,)
    raise KeyError(name)


@pytest.mark.parametrize("site", [
    "spmv_dense", "spmv_banded", "banded_ring", "coarsest_solve",
    "range_update_dense", "blas_dot_norm2", "gmres"])
def test_pinned_products_carry_highest(site):
    """Every dot_general of the pinned sites asks for HIGHEST precision:
    on a GPU the default may run f32 products in TF32 (~1e-3)."""
    import jax

    fn, args = _site(site)
    dots = _dot_generals(jax.make_jaxpr(fn)(*args).jaxpr)
    assert dots, f"{site}: no dot_general traced"
    hi = jax.lax.Precision.HIGHEST
    for eqn in dots:
        assert eqn.params["precision"] == (hi, hi), (site, eqn)


def test_compile_cache_takes_env_dir_verbatim(monkeypatch, tmp_path):
    import jax
    from amg_tpu import compile_cache

    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")
    assert compile_cache.enable() == str(tmp_path / "c")
    # nothing else is set: JAX reads the variable itself
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    from amg_tpu import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.cache_dir()
    assert d == compile_cache.cache_dir()          # no pid/time/tempname
    assert os.path.dirname(d) == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("backend", ["cpu", "gpu", "cuda"])
def test_embed_levels_auto_is_zero_on_every_backend(monkeypatch, backend):
    import jax
    from amg_tpu.hierarchy import resolved_embed_levels

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolved_embed_levels(amg.AMGParams()) == 0
    assert resolved_embed_levels(amg.AMGParams(embed_levels=3)) == 3


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    out = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stdout + out.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_hbm_peak_table():
    from amg_tpu.device import hbm_peak

    assert hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError):
        hbm_peak("cpu")


def test_require_gpu_refuses_the_cpu():
    from amg_tpu.device import require_gpu

    with pytest.raises(SystemExit):
        require_gpu()
