"""Smoothed-aggregation (SA) coarsening.

No reference equivalent (the reference is classical RS-AMG only,
amg/Setup/SSS_coarsen.c); this is the extension flagged in
ROADMAP.md: aggregation keeps coarse operators *leaner* than RS —
aggregates of ~3^d nodes coarsen ~3x faster per level with smaller
Galerkin stencils, which is exactly what the fine-grid embedding wants
at depth (fewer embedded diagonals per level).

Standard Vanek-style aggregation + smoothed prolongation:

* :func:`aggregate` — three-phase greedy aggregation over the strength
  graph S: (1) seed aggregates at nodes whose strong neighborhood is
  fully unassigned, (2) attach remaining nodes to the strongest
  neighboring aggregate, (3) sweep leftovers into new aggregates of
  their unassigned strong neighbors.
* :func:`sa_interpolation` — tentative piecewise-constant P0 (the
  scalar-PDE near-null space = ones), then one damped-Jacobi smoothing
  pass ``P = (I - omega D^-1 A) P0`` with ``omega = (4/3) / rho(D^-1 A)``.
"""

from __future__ import annotations

import numpy as np

from ..sparse import CSR


def aggregate(s: CSR) -> tuple[np.ndarray, int]:
    """Greedy strength-graph aggregation.

    Returns ``(agg, n_agg)`` where ``agg[i]`` is the aggregate id of row i
    (or -1 for isolated nodes with no strong couplings — they receive an
    empty P row, like the reference's ISPT points).
    """
    from .. import native

    if native.lib is not None:
        return native.lib.sa_aggregate(s)
    n = s.n_rows
    sp, sj = s.indptr, s.indices
    agg = np.full(n, -2, dtype=np.int64)  # -2 unassigned, -1 isolated
    deg = np.diff(sp)
    agg[deg == 0] = -1

    n_agg = 0
    # phase 1: seed aggregates where the full strong neighborhood is free
    for i in range(n):
        if agg[i] != -2:
            continue
        nbrs = sj[sp[i]:sp[i + 1]]
        if np.all(agg[nbrs] == -2):
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    # phase 2: attach stragglers to a neighboring aggregate
    attach = np.flatnonzero(agg == -2)
    for i in attach:
        nbrs = sj[sp[i]:sp[i + 1]]
        assigned = agg[nbrs]
        hit = assigned[assigned >= 0]
        if len(hit):
            # most-connected neighboring aggregate
            ids, counts = np.unique(hit, return_counts=True)
            agg[i] = ids[np.argmax(counts)]
    # phase 3: leftovers seed new aggregates with their free neighbors
    for i in range(n):
        if agg[i] != -2:
            continue
        agg[i] = n_agg
        nbrs = sj[sp[i]:sp[i + 1]]
        free = nbrs[agg[nbrs] == -2]
        agg[free] = n_agg
        n_agg += 1
    return agg, n_agg


def tentative_p(agg: np.ndarray, n_agg: int) -> CSR:
    """Piecewise-constant tentative prolongation P0 (n x n_agg)."""
    n = len(agg)
    member = agg >= 0
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = member.astype(np.int64)
    np.cumsum(indptr, out=indptr)
    return CSR(
        indptr,
        agg[member].astype(np.int32),
        np.ones(int(member.sum()), dtype=np.float64),
        (n, n_agg),
    )


def sa_interpolation(a: CSR, agg: np.ndarray, n_agg: int,
                     rho: float | None = None) -> CSR:
    """Smoothed prolongation ``P = (I - omega D^-1 A) P0``."""
    from ..hierarchy import _rho_dinv_a_host
    from ..ops.spgemm import spgemm
    from ..params import SMALLFLOAT

    p0 = tentative_p(agg, n_agg)
    if rho is None:
        rho = _rho_dinv_a_host(a)
    omega = (4.0 / 3.0) / max(rho, SMALLFLOAT)

    ap0 = spgemm(a, p0)
    d = a.diagonal_fast()
    dinv = np.where(np.abs(d) > SMALLFLOAT,
                    1.0 / np.where(d != 0, d, 1.0), 0.0)
    rows_ap = np.repeat(np.arange(a.n_rows, dtype=np.int64),
                        ap0.row_degrees)
    scaled = -omega * dinv[rows_ap] * ap0.data
    rows_p0 = np.repeat(np.arange(a.n_rows, dtype=np.int64),
                        p0.row_degrees)
    return CSR.from_coo(
        np.concatenate([rows_p0, rows_ap]),
        np.concatenate([p0.indices.astype(np.int64),
                        ap0.indices.astype(np.int64)]),
        np.concatenate([p0.data, scaled]),
        (a.n_rows, n_agg),
    )
