"""Sparse matrix-vector products on device.

The hot kernel of the whole framework (SURVEY.md section 3.5): the
reference's CSR SpMV is a scalar row loop on CPU (``SSS_blas_mv_mxy``,
amg/SSS_utils.c:182-201) and a thread-per-row CUDA kernel
(``spmv_kernel``, amg/Solve/SSS_cuda.cu:77-96).

Every format is plain XLA: padded ELL (:class:`amg_tpu.sparse.Ell`) is

    y[i] = sum_w vals[i, w] * x[cols[i, w]]

a rectangular gather + multiply + small-axis reduction; DIA is static
shifted slices + FMA.  XLA fuses the multiply and reduction (and the
caller's elementwise epilogue, e.g. ``b - A x``) into one loop, so each
product is memory-bandwidth bound.  There is no host<->device traffic per
call (the reference copies A, x, y to the GPU on *every* SpMV,
amg/Solve/SSS_cuda.cu:124-139).

Matrix products that XLA may hand to the tensor cores (Dense levels,
BandedBlocks) pin ``precision=HIGHEST``: the default lets f32 run in
TF32 (~1e-3 relative error), which would leave the solve short of its
tolerance.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import Ell, Dia, Dense, BandedBlocks, WEll
from .blas import HIGHEST


def spmv_ell(a: Ell, x: jnp.ndarray) -> jnp.ndarray:
    """Gather-based ELL SpMV (general fallback)."""
    gathered = x[a.cols]                      # (pr, w) gather
    y = jnp.sum(a.vals * gathered, axis=1)
    return y


def spmv_well(a: WEll, x: jnp.ndarray) -> jnp.ndarray:
    """Windowed-gather ELL SpMV: decode each slot's (window, loc) pair
    into a global column index, then one gather + multiply + slot sum."""
    pc = a.pad_cols
    xp = jnp.pad(x, (0, pc - x.shape[0])) if x.shape[0] < pc else x[:pc]
    loc32 = a.loc.astype(jnp.int32)
    r = loc32 & 127
    q = jnp.take_along_axis(loc32, r, axis=3) >> 7   # Q table at lane=r
    idx = (a.base.astype(jnp.int32)[:, :, None, None] + q) * 128 + r
    v = a.vals
    if a.vals_lo is not None:
        # df64 split pack: recombine to the x precision (exact in f64)
        v = v.astype(x.dtype) + a.vals_lo.astype(x.dtype)
    if v.dtype != x.dtype:
        v = v.astype(x.dtype)
    y = jnp.sum(v * xp[idx], axis=1)
    return y.reshape(a.padded_rows)


def spmv_dia(a: Dia, x: jnp.ndarray) -> jnp.ndarray:
    """Diagonal-offset SpMV: static shifted slices + FMA, no gathers.

    Narrow stencils unroll fully (XLA fuses the FMA chain into one loop;
    the repeated x reads at neighbouring offsets hit cache).  Wide
    stencils (embedded coarse operators can have hundreds of diagonals)
    run as a ``lax.scan`` over chunks of diagonals so the program stays
    small while each chunk still fuses.
    """
    pad = a.padded_rows
    nd = len(a.offsets)
    lo = max(-min(a.offsets), 0) if a.offsets else 0
    hi = max(max(a.offsets), 0) if a.offsets else 0
    xp = jnp.pad(x, (lo, hi))

    chunk = 16
    if nd <= 512:
        y = jnp.zeros((pad,), x.dtype)
        for k, off in enumerate(a.offsets):
            start = lo + off
            y = y + a.vals[k] * jax.lax.slice(xp, (start,), (start + pad,))
        return y

    nchunks = (nd + chunk - 1) // chunk
    nd_pad = nchunks * chunk
    vals = a.vals
    starts = np.asarray(a.offsets, dtype=np.int32) + lo
    if nd_pad != nd:
        vals = jnp.pad(vals, ((0, nd_pad - nd), (0, 0)))
        starts = np.pad(starts, (0, nd_pad - nd))
    vals_c = vals.reshape(nchunks, chunk, pad)
    starts_c = jnp.asarray(starts.reshape(nchunks, chunk))

    def body(y, sc):
        v, s = sc
        for j in range(chunk):
            y = y + v[j] * jax.lax.dynamic_slice(xp, (s[j],), (pad,))
        return y, None

    y, _ = jax.lax.scan(body, jnp.zeros((pad,), x.dtype), (vals_c, starts_c))
    return y


def spmv_dense(a: Dense, x: jnp.ndarray) -> jnp.ndarray:
    """Dense matvec (small deep levels; no gathers)."""
    return jnp.matmul(a.vals, x[: a.padded_cols], precision=HIGHEST)


def spmv_banded(a: BandedBlocks, x: jnp.ndarray) -> jnp.ndarray:
    """Block-banded SpMV: static shifted x slices + one batched 128x128
    block matvec — streaming, no gathers.  The RCM-ordered replacement
    for gather-ELL coarse levels."""
    nbr = a.vals.shape[0]
    w = a.vals.shape[1]
    nb = a.nb
    pad = nbr * 128
    xp = jnp.pad(x[:pad], (nb * 128, nb * 128)).astype(a.vals.dtype)
    xw = jnp.stack(
        [jax.lax.slice(xp, (d * 128,), (d * 128 + pad,)).reshape(nbr, 128)
         for d in range(w)],
        axis=1,
    )  # (nbr, w, 128): block-column d of block-row i = x block i + d - nb
    y = jnp.einsum("idrc,idc->ir", a.vals, xw,
                   preferred_element_type=x.dtype, precision=HIGHEST)
    return y.reshape(pad).astype(x.dtype)


def spmv(a, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x. Returns a vector of length ``a.padded_rows`` (padding rows
    produce zeros because their values are zero).  Dispatches on format."""
    if isinstance(a, Dia):
        return spmv_dia(a, x)
    if isinstance(a, Dense):
        return spmv_dense(a, x)
    if isinstance(a, BandedBlocks):
        return spmv_banded(a, x)
    if isinstance(a, WEll):
        return spmv_well(a, x)
    return spmv_ell(a, x)


def spmv_n(a: Ell, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x truncated to the logical row count."""
    return spmv(a, x)[: a.n_rows]


def residual(a: Ell, x: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """r = b - A @ x (reference ``SSS_blas_mv_amxpy`` with alpha=-1 as used
    by the outer loop, amg/Solve/SSS_SOLVE.c:59-60)."""
    return b - spmv(a, x)[: b.shape[0]]
