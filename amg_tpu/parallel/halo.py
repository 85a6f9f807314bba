"""Explicit ring halo-exchange SpMV for row-sharded DIA operators.

The GSPMD path (parallel/dist.py) lets XLA infer the boundary exchange
from the DIA shifted slices.  This module is the hand-placed alternative
— the scaling-book "pick the collective yourself" pattern:

* each shard owns a contiguous block of ``m`` rows and the matching
  slice of every vector;
* a band of half-width ``lo``/``hi`` needs exactly the last ``lo``
  entries of the left neighbor and the first ``hi`` entries of the right
  neighbor — two neighbor ``ppermute`` s, nothing global;
* the local product then runs on the assembled window with the same
  shifted-slice product as the single-device path.

Functions here are written to be called INSIDE ``shard_map``; see
:func:`spmv_dia_ring` for the wrapped convenience entry point.

No reference equivalent: the reference is single-address-space
(``SSS_blas_mv_mxy`` gathers globally, amg/SSS_utils.c:182-201); the halo
design realizes SURVEY.md section 5's "long-context analog" row-partition
plan.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sparse import Dia
from ..ops.blas import HIGHEST


def dia_halo_widths(offsets) -> tuple[int, int]:
    lo = max(-min(offsets), 0)
    hi = max(max(offsets), 0)
    return lo, hi


def dia_spmv_local(offsets, vals_local: jnp.ndarray,
                   xw: jnp.ndarray) -> jnp.ndarray:
    """Local product on an already-haloed window.

    ``vals_local``: (nd, m) value planes of this shard's rows;
    ``xw``: (lo + m + hi,) window = [left halo | local x | right halo].
    """
    m = vals_local.shape[1]
    lo, _ = dia_halo_widths(offsets)
    acc = jnp.zeros((m,), xw.dtype)
    for k, off in enumerate(offsets):
        s = lo + off
        acc = acc + vals_local[k] * jax.lax.slice(xw, (s,), (s + m,))
    return acc


def _ring_halos(offsets, n_shards: int, axis_name: str,
                x_local: jnp.ndarray):
    """Left/right halo slabs for this shard via neighbor ``ppermute`` s.

    Halos wider than one shard block take multiple hops (j-distance
    ``ppermute`` per neighbor ring); edge shards receive zeros (no
    wrap-around: out-of-range band positions are zero), which is exactly
    the global operator's boundary behavior.  Returns ``(left, right)``
    with shapes ``(lo,)`` / ``(hi,)`` (``None`` when the width is 0).
    """
    lo, hi = dia_halo_widths(offsets)
    m = x_local.shape[0]
    k_lo = -(-lo // m) if lo else 0   # ceil
    k_hi = -(-hi // m) if hi else 0
    if max(k_lo, k_hi) > max(n_shards - 1, 0):
        # halo spans the whole mesh: every out-of-mesh block is zero,
        # clamp the hop count (the extra band positions read zeros)
        k_lo = min(k_lo, n_shards - 1)
        k_hi = min(k_hi, n_shards - 1)
    left = right = None
    if lo:
        blocks = [
            jax.lax.ppermute(
                x_local, axis_name,
                [(i, i + j) for i in range(n_shards - j)],
            )
            for j in range(k_lo, 0, -1)
        ]  # farthest neighbor first -> ascending global position
        if not blocks:  # single shard: the whole halo is out of range
            left = jnp.zeros((lo,), x_local.dtype)
        else:
            left = jnp.concatenate(blocks) if len(blocks) > 1 else blocks[0]
            want = k_lo * m
            if want > lo:
                left = left[want - lo:]
            elif want < lo:
                # hop count clamped at the mesh edge: missing blocks zero
                left = jnp.concatenate(
                    [jnp.zeros((lo - want,), x_local.dtype), left])
    if hi:
        blocks = [
            jax.lax.ppermute(
                x_local, axis_name,
                [(i + j, i) for i in range(n_shards - j)],
            )
            for j in range(1, k_hi + 1)
        ]
        if not blocks:
            right = jnp.zeros((hi,), x_local.dtype)
        else:
            right = jnp.concatenate(blocks) if len(blocks) > 1 else blocks[0]
            if right.shape[0] > hi:
                right = right[:hi]
            elif right.shape[0] < hi:
                right = jnp.concatenate(
                    [right,
                     jnp.zeros((hi - right.shape[0],), x_local.dtype)])
    return left, right


# row-block granularity for the interior/boundary split (keeps every
# sub-block 128-row aligned)
_SPLIT_ROUND = 4096


def dia_spmv_ring_local(offsets, n_shards: int, axis_name: str,
                        vals_local: jnp.ndarray, x_local: jnp.ndarray,
                        overlap: bool = True) -> jnp.ndarray:
    """One shard's y = (A x)_local with neighbor halo exchange.

    Call INSIDE shard_map.  With ``overlap`` (default), rows are split
    into an interior block (band stays inside the local x slice) and two
    boundary bands that are the only consumers of the ``ppermute`` d
    halos; the interior product carries no data dependency on the
    collectives, so XLA's latency-hiding scheduler runs the transfers
    concurrently with the interior SpMV — the BASELINE.json north-star
    "halo exchange overlapped with local SpMV compute".  Numerics are
    unchanged: each row sees the same per-diagonal accumulation order.
    """
    lo, hi = dia_halo_widths(offsets)
    m = x_local.shape[0]
    left, right = _ring_halos(offsets, n_shards, axis_name, x_local)

    # boundary band heights, rounded to the block granularity; fall back
    # to the monolithic window when the shard is too small to split
    t = -(-lo // _SPLIT_ROUND) * _SPLIT_ROUND if lo else 0
    bt = -(-hi // _SPLIT_ROUND) * _SPLIT_ROUND if hi else 0
    if overlap and t + bt < m and (t or bt) and m % 128 == 0:
        parts = []
        if t:
            xw_top = jnp.concatenate([left, x_local[:t + hi]])
            parts.append(dia_spmv_local(offsets, vals_local[:, :t], xw_top))
        # interior rows [t, m-bt): window x_local[t-lo : m-bt+hi] is fully
        # local (t >= lo, bt >= hi by construction) — no halo dependency,
        # so it overlaps with the ppermutes above
        xw_int = jax.lax.slice(x_local, (t - lo,), (m - bt + hi,))
        parts.append(dia_spmv_local(offsets, vals_local[:, t:m - bt],
                                    xw_int))
        if bt:
            xw_bot = jnp.concatenate([x_local[m - bt - lo:], right])
            parts.append(dia_spmv_local(offsets, vals_local[:, m - bt:],
                                        xw_bot))
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    parts = []
    if left is not None:
        parts.append(left)
    parts.append(x_local)
    if right is not None:
        parts.append(right)
    xw = jnp.concatenate(parts) if len(parts) > 1 else x_local
    return dia_spmv_local(offsets, vals_local, xw)


def spmv_dia_ring(d: Dia, x: jnp.ndarray, mesh: Mesh,
                  axis: str = "x") -> jnp.ndarray:
    """y = A @ x with the operator row-sharded over ``mesh[axis]``.

    Convenience wrapper: shards the value planes and the vector, runs the
    ring-halo product under ``shard_map``, returns a row-sharded y of
    length ``padded_rows``.  ``padded_rows`` must divide evenly by the
    mesh size (re-pad with :func:`dist._pad_dia_multiple` first).
    """
    from jax import shard_map

    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                            if a == axis]))
    pad = d.padded_rows
    if pad % n_shards != 0:
        raise ValueError(f"padded_rows {pad} not divisible by {n_shards}")

    fn = shard_map(
        partial(dia_spmv_ring_local, tuple(d.offsets), n_shards, axis),
        mesh=mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=P(axis),
    )
    return fn(d.vals, x)


# ---------------------------------------------------------------------------
# WEll ring (round 5): the multi-chip path for unstructured levels
# ---------------------------------------------------------------------------


def well_shard_plan(w, n_shards: int,
                    in_m128: int | None = None) -> tuple[int, int]:
    """Per-mesh halo widths (128-row units) for a row-sharded WEll
    operator (device-array convenience wrapper over
    :meth:`WEll.ring_plan_host`; production packs precompute the plan on
    the host arrays and store it in ``w.ring_plan``).

    After the RCM / barycentric ordering windows hug the diagonal, so
    lo/hi come out near the matrix's (block) bandwidth and the halo stays
    thin.  For rectangular operators (P/R) pass ``in_m128`` = input-vector
    128-row blocks per shard.
    """
    from ..sparse import WEll as _WEll

    if w.ring_plan is not None:
        return w.ring_plan
    base = np.asarray(w.base)
    if in_m128 is None:
        in_m128 = base.shape[0] // n_shards * 8
    return _WEll.ring_plan_host(base, np.asarray(w.vals), n_shards,
                                in_m128)


def well_spmv_ring_local(w, x_local: jnp.ndarray, axis_name: str,
                         n_shards: int, lo128: int,
                         hi128: int) -> jnp.ndarray:
    """One shard's y = (A x)_local for a groups-sharded WEll operator.

    Call INSIDE shard_map with ``w`` sliced to this shard's groups
    (specs: vals/loc P(axis,...), base P(axis, None)).  Neighbor x
    blocks arrive via the same multi-hop ``ppermute`` rings as the DIA
    path; window bases are rebased to the local haloed view and clamped
    (inactive slots carry zero values, so their clamped window reads are
    harmless).
    """
    m = x_local.shape[0]
    m128 = m // 128
    lo, hi = lo128 * 128, hi128 * 128
    offsets = (-lo,) if lo else ()
    offsets = offsets + ((hi,) if hi else ())
    if offsets:
        left, right = _ring_halos(offsets, n_shards, axis_name, x_local)
    else:
        left = right = None
    parts = ([left] if left is not None else []) + [x_local] \
        + ([right] if right is not None else [])
    xw = jnp.concatenate(parts) if len(parts) > 1 else x_local
    xrows = lo128 + m128 + hi128

    s_idx = jax.lax.axis_index(axis_name).astype(jnp.int32)
    off = s_idx * jnp.int32(m128) - jnp.int32(lo128)
    base_local = jnp.clip(w.base.astype(jnp.int32) - off, 0,
                          jnp.int32(max(xrows - 8, 0)))

    return _well_apply(w, base_local, xw, xrows)


def _well_apply(w, base_i32: jnp.ndarray, xw: jnp.ndarray,
                xrows: int) -> jnp.ndarray:
    """Windowed-gather product of a (sliced) WEll operator against an
    x window of ``xrows`` 128-row blocks, bases already expressed in
    window coordinates (vmapped over groups and slots)."""
    ngroups_l = w.vals.shape[0]
    x2d = xw.reshape(xrows, 128)
    vals = w.vals
    if w.vals_lo is not None and jnp.dtype(xw.dtype) == jnp.float64:
        # df64 split-pack recombined at full precision
        vals = vals.astype(jnp.float64) + w.vals_lo.astype(jnp.float64)

    def slot(b, lc, v):
        tbl = jax.lax.dynamic_slice(x2d, (b, jnp.int32(0)), (8, 128))
        lc = lc.astype(jnp.int32)
        q_tab = jax.lax.shift_right_logical(lc, jnp.int32(7))
        r = jax.lax.bitwise_and(lc, jnp.int32(127))
        gx = jnp.take_along_axis(
            jnp.take_along_axis(tbl, q_tab, axis=0), r, axis=1)
        return v.astype(xw.dtype) * gx

    outs = jax.vmap(jax.vmap(slot))(base_i32, w.loc, vals).sum(axis=1)
    return outs.astype(xw.dtype).reshape(ngroups_l * 1024)


def well_spmv_local_full(w, x_full: jnp.ndarray) -> jnp.ndarray:
    """Product of a groups-SLICED WEll operator against the FULL
    (replicated) input vector — the boundary prolongation of the general
    sharded cycle: P's rows are sharded but the coarse correction is
    replicated, so no exchange is needed and the global window bases
    apply unchanged."""
    pc = w.pad_cols
    xp = jnp.pad(x_full, (0, pc - x_full.shape[0])) \
        if x_full.shape[0] < pc else x_full[:pc]
    return _well_apply(w, w.base.astype(jnp.int32), xp, pc // 128)


def spmv_well_ring(w, x: jnp.ndarray, mesh: Mesh,
                   axis: str = "x") -> jnp.ndarray:
    """y = A @ x with a WEll operator row-group-sharded over
    ``mesh[axis]`` — the wrapped convenience entry (tests / direct use).
    """
    from jax import shard_map

    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                            if a == axis]))
    lo128, hi128 = well_shard_plan(w, n_shards)
    pad = w.padded_rows
    xp = jnp.pad(x, (0, pad - x.shape[0])) if x.shape[0] < pad else x[:pad]

    from ..sparse import WEll as _WEll

    specs = _WEll(P(axis, None, None, None), P(axis, None, None, None),
                  P(axis, None), w.shape, w.nnz, w.pad_cols,
                  None if w.vals_lo is None else P(axis, None, None, None),
                  w.ring_plan)
    fn = shard_map(
        lambda wl, xl: well_spmv_ring_local(wl, xl, axis, n_shards,
                                            lo128, hi128),
        mesh=mesh,
        in_specs=(specs, P(axis)),
        out_specs=P(axis),
    )
    return fn(w, xp)


# ---------------------------------------------------------------------------
# BandedBlocks ring (round 5): block-banded levels across the mesh
# ---------------------------------------------------------------------------


def banded_spmv_ring_local(nb: int, n_shards: int, axis_name: str,
                           vals_local: jnp.ndarray,
                           x_local: jnp.ndarray) -> jnp.ndarray:
    """One shard's y = (A x)_local for a block-row-sharded BandedBlocks
    operator: the halo is exactly ``nb`` 128-blocks each way (the block
    band), then the same batched block product as the single-device
    :func:`amg_tpu.ops.spmv.spmv_banded`.  Out-of-mesh halo blocks read
    zeros — identical to the global operator's zero padding.
    """
    nbr_l, w = vals_local.shape[0], vals_local.shape[1]
    m = nbr_l * 128
    halo = nb * 128
    if halo:
        left, right = _ring_halos((-halo, halo), n_shards, axis_name,
                                  x_local)
        xw = jnp.concatenate([left, x_local, right])
    else:
        xw = x_local
    xw = xw.astype(vals_local.dtype)
    xws = jnp.stack(
        [jax.lax.slice(xw, (d * 128,), (d * 128 + m,)).reshape(nbr_l, 128)
         for d in range(w)],
        axis=1,
    )
    y = jnp.einsum("idrc,idc->ir", vals_local, xws,
                   preferred_element_type=x_local.dtype,
                   precision=HIGHEST)
    return y.reshape(m).astype(x_local.dtype)


def spmv_banded_ring(a, x: jnp.ndarray, mesh: Mesh,
                     axis: str = "x") -> jnp.ndarray:
    """y = A @ x with a BandedBlocks operator block-row-sharded over
    ``mesh[axis]``."""
    from jax import shard_map

    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                            if a == axis]))
    nbr = a.vals.shape[0]
    if nbr % n_shards != 0:
        raise ValueError(f"block rows {nbr} not divisible by {n_shards}")
    pad = nbr * 128
    xp = jnp.pad(x, (0, pad - x.shape[0])) if x.shape[0] < pad else x[:pad]
    fn = shard_map(
        partial(banded_spmv_ring_local, a.nb, n_shards, axis),
        mesh=mesh,
        in_specs=(P(axis, None, None, None), P(axis)),
        out_specs=P(axis),
    )
    return fn(a.vals, xp)


def well_spmv_ring_local_df64(w, x64_local: jnp.ndarray, axis_name: str,
                              n_shards: int, lo128: int,
                              hi128: int) -> jnp.ndarray:
    """f64 ring product of a groups-sharded df64 WEll pack: the f64
    vector is exchanged directly and the split planes recombine to the
    f64 operator in the local apply."""
    m = x64_local.shape[0]
    m128 = m // 128
    lo, hi = lo128 * 128, hi128 * 128
    xrows = lo128 + m128 + hi128
    s_idx = jax.lax.axis_index(axis_name).astype(jnp.int32)
    off = s_idx * jnp.int32(m128) - jnp.int32(lo128)
    base_local = jnp.clip(w.base.astype(jnp.int32) - off, 0,
                          jnp.int32(max(xrows - 8, 0)))
    offs = ((-lo,) if lo else ()) + ((hi,) if hi else ())
    if offs:
        left, right = _ring_halos(offs, n_shards, axis_name, x64_local)
        xw = jnp.concatenate([p for p in (left, x64_local, right)
                              if p is not None])
    else:
        xw = x64_local
    return _well_apply(w, base_local, xw, xrows)
