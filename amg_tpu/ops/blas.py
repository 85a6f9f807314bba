"""BLAS-1 device operations.

Replaces the reference's scalar-loop array ops (``SSS_blas_array_*``,
amg/SSS_utils.c:151-260) with jnp reductions/elementwise ops that XLA fuses
and vectorizes.  All functions are jit-safe and, under ``shard_map``,
reduce across the mesh axis when ``axis_name`` is given — the distributed
form of the global dots the reference computes in a single address space
(SURVEY.md section 2, "Distributed communication backend").  Dots pin
``precision=HIGHEST`` so an f32 reduction never runs in TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def _maybe_psum(x, axis_name):
    if axis_name is not None:
        return jax.lax.psum(x, axis_name)
    return x


def dot(x, y, axis_name=None):
    """<x, y> (reference SSS_blas_array_dot, amg/SSS_utils.c:206)."""
    return _maybe_psum(jnp.vdot(x, y, precision=HIGHEST), axis_name)


def norm2(x, axis_name=None):
    """||x||_2 (reference SSS_blas_array_norm2, amg/SSS_utils.c:151)."""
    return jnp.sqrt(_maybe_psum(jnp.vdot(x, x, precision=HIGHEST),
                                axis_name))


def norminf(x, axis_name=None):
    """||x||_inf (reference SSS_blas_array_norminf, amg/SSS_utils.c:225)."""
    m = jnp.max(jnp.abs(x)) if x.size else jnp.zeros((), x.dtype)
    if axis_name is not None:
        m = jax.lax.pmax(m, axis_name)
    return m


def axpy(alpha, x, y):
    """y + alpha*x (reference SSS_blas_array_axpy, amg/SSS_utils.c:217)."""
    return y + alpha * x


def axpby(alpha, x, beta, y):
    """alpha*x + beta*y (reference SSS_blas_array_axpby, amg/SSS_utils.c:248)."""
    return alpha * x + beta * y
