"""Sparse matrix containers.

Two worlds:

* **Host**: :class:`CSR` — numpy compressed-sparse-row, used by the setup
  phase (coarsening / interpolation / Galerkin product are irregular,
  data-dependent-shape graph algorithms that belong on the host, exactly as
  the reference runs them on the CPU — reference ``SSS_MAT``,
  amg/SSS_main.h:95-105).

* **Device**: :class:`Ell` — padded ELLPACK, a rectangular (rows x width)
  layout with per-row column indices.  Static shapes and contiguous gathers
  make it a natural accelerator representation: SpMV becomes a dense
  gather + multiply + row-reduction that XLA fuses into one loop, with no
  data-dependent shapes under ``jit``.  This replaces the reference's
  thread-per-CSR-row CUDA kernel (amg/Solve/SSS_cuda.cu:77-96).

Rows are padded to the next multiple of 8 and the width to the
actual max row degree; padding entries carry ``col = row`` (a self-reference,
always a valid index) and ``val = 0`` so no masks are needed in compute.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# arrays above this size are built by scattering nnz triplets ON DEVICE
# instead of materializing + uploading the full array from the host (host
# alloc and transfer dominate setup for sparse embedded stencils)
_DEVICE_BUILD_BYTES = 64 * 1024 * 1024


def _device_scatter_2d(shape, rows, cols, data, dtype) -> jnp.ndarray:
    """zeros(shape).at[rows, cols].set(data) with minimal host->device
    traffic (indices+values only).

    Scatters into the FLATTENED array with 1-D linear indices: one index
    vector instead of a 2-D ``s32[nnz, 2]`` index operand, half the index
    bytes at tens of millions of entries.  Linear indices are i64
    (nd * pad_rows can exceed 2^31).
    """
    inner = int(np.prod(shape[1:]))
    n_flat = int(shape[0]) * inner
    lin = (np.ascontiguousarray(rows, dtype=np.int64) * np.int64(inner)
           + np.ascontiguousarray(cols, dtype=np.int64))
    idx = jnp.asarray(lin)
    v = jnp.asarray(np.asarray(data, dtype=np.dtype(dtype)))
    flat = jnp.zeros(n_flat, dtype=np.dtype(dtype)).at[idx].set(
        v, unique_indices=True
    )
    return flat.reshape(shape)


# ---------------------------------------------------------------------------
# Host CSR
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CSR:
    """Host-side CSR matrix (int32 indices, float64 values)."""

    indptr: np.ndarray   # (n_rows + 1,) int32/int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray     # (nnz,) float64
    shape: Tuple[int, int]

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_coo(rows, cols, vals, shape, sum_duplicates: bool = True) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        # fast path: already in strict CSR order (common for re-indexed /
        # generated matrices) -> skip the O(nnz log nnz) lexsort entirely
        if len(rows):
            key = rows * shape[1] + cols
            if np.all(np.diff(key) > 0):
                indptr = np.zeros(shape[0] + 1, dtype=np.int64)
                indptr[1:] = np.bincount(rows, minlength=shape[0])
                np.cumsum(indptr, out=indptr)
                return CSR(indptr, cols.astype(np.int32), vals, tuple(shape))
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows):
            dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if dup.any():
                keep = np.concatenate([[True], ~dup])
                grp = np.cumsum(keep) - 1
                out_vals = np.zeros(keep.sum(), dtype=np.float64)
                np.add.at(out_vals, grp, vals)
                rows, cols, vals = rows[keep], cols[keep], out_vals
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        indptr[1:] = np.bincount(rows, minlength=shape[0])
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, cols.astype(np.int32), vals, tuple(shape))

    @staticmethod
    def from_dense(a: np.ndarray, tol: float = 0.0) -> "CSR":
        a = np.asarray(a, dtype=np.float64)
        rows, cols = np.nonzero(np.abs(a) > tol)
        return CSR.from_coo(rows, cols, a[rows, cols], a.shape)

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        return CSR(
            np.asarray(m.indptr, dtype=np.int64),
            np.asarray(m.indices, dtype=np.int32),
            np.asarray(m.data, dtype=np.float64),
            tuple(m.shape),
        )

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    # -- basic properties ----------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def row_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def row_indices(self) -> np.ndarray:
        """Row index per entry (``np.repeat`` over degrees), memoized —
        the expansion costs ~seconds at 100M nnz and the setup phase asks
        for it many times per level."""
        r = getattr(self, "_row_idx_cache", None)
        if r is None or len(r) != self.nnz:
            r = np.repeat(
                np.arange(self.n_rows, dtype=np.int64), self.row_degrees
            )
            self._row_idx_cache = r
        return r

    # -- ops -----------------------------------------------------------------

    def diagonal(self) -> np.ndarray:
        """First-match diagonal per row (reference ``SSS_mat_get_diag``,
        amg/SSS_matvec.c:162)."""
        n = min(self.shape)
        diag = np.zeros(n, dtype=np.float64)
        for i in range(n):
            seg = slice(self.indptr[i], self.indptr[i + 1])
            hits = np.nonzero(self.indices[seg] == i)[0]
            if hits.size:
                diag[i] = self.data[self.indptr[i] + hits[0]]
        return diag

    def diagonal_fast(self) -> np.ndarray:
        """Vectorized diagonal extraction."""
        n = min(self.shape)
        rows = self.row_indices
        mask = (self.indices == rows) & (rows < n)
        diag = np.zeros(n, dtype=np.float64)
        diag[rows[mask]] = self.data[mask]
        return diag

    def transpose(self) -> "CSR":
        """Two-pass histogram transpose (reference ``SSS_mat_trans``,
        amg/SSS_matvec.c:330-387)."""
        try:
            from .native import lib as _native
        except Exception:
            _native = None
        if _native is not None and self.nnz:
            return _native.csr_transpose(self)
        n_rows, n_cols = self.shape
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), self.row_degrees)
        order = np.argsort(self.indices, kind="stable")
        new_indptr = np.zeros(n_cols + 1, dtype=np.int64)
        new_indptr[1:] = np.bincount(self.indices, minlength=n_cols)
        np.cumsum(new_indptr, out=new_indptr)
        return CSR(
            new_indptr,
            rows[order].astype(np.int32),
            self.data[order],
            (n_cols, n_rows),
        )

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x (host reference implementation; reference
        ``SSS_blas_mv_mxy``, amg/SSS_utils.c:182-201)."""
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), self.row_degrees)
        prod = self.data * x[self.indices]
        y = np.zeros(self.n_rows, dtype=np.result_type(self.data, x))
        np.add.at(y, rows, prod)
        return y

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        out = np.zeros(self.shape, dtype=dtype)
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), self.row_degrees)
        # duplicates (shouldn't exist) would overwrite; fine for tests
        np.add.at(out, (rows, self.indices), self.data.astype(dtype, copy=False))
        return out

    def sort_indices(self) -> "CSR":
        """Return a copy with column indices sorted within each row."""
        indices = self.indices.copy()
        data = self.data.copy()
        for i in range(self.n_rows):
            s, e = self.indptr[i], self.indptr[i + 1]
            order = np.argsort(indices[s:e], kind="stable")
            indices[s:e] = indices[s:e][order]
            data[s:e] = data[s:e][order]
        return CSR(self.indptr.copy(), indices, data, self.shape)

    def copy(self) -> "CSR":
        return CSR(
            self.indptr.copy(), self.indices.copy(), self.data.copy(), self.shape
        )

    # -- permutations (vectorized) -------------------------------------------

    def permute_rows(self, perm: np.ndarray) -> "CSR":
        """Rows reordered: new row ``i`` is old row ``perm[i]``."""
        perm = np.asarray(perm, dtype=np.int64)
        deg = self.row_degrees
        new_deg = deg[perm]
        new_indptr = np.zeros(self.n_rows + 1, dtype=np.int64)
        np.cumsum(new_deg, out=new_indptr[1:])
        # source slot of each output nnz
        pos = np.arange(int(new_indptr[-1]), dtype=np.int64) - np.repeat(
            new_indptr[:-1], new_deg
        )
        src = np.repeat(self.indptr[perm], new_deg) + pos
        return CSR(new_indptr, self.indices[src], self.data[src], self.shape)

    def permute_cols(self, col_map: np.ndarray) -> "CSR":
        """Columns relabeled: old column ``c`` becomes ``col_map[c]``."""
        col_map = np.asarray(col_map, dtype=np.int64)
        return CSR(
            self.indptr.copy(),
            col_map[self.indices].astype(np.int32),
            self.data.copy(),
            self.shape,
        )

    def permute(self, perm: np.ndarray) -> "CSR":
        """Symmetric permutation ``P A P^T`` of a square matrix: new index
        ``i`` is old index ``perm[i]``."""
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=np.int64)
        return self.permute_rows(perm).permute_cols(inv)


# ---------------------------------------------------------------------------
# Device ELL
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Ell:
    """Padded ELLPACK matrix on device.

    ``cols``/``vals`` have shape ``(padded_rows, width)``.  Padding slots
    point at the row's own index with value 0 so gathers stay in bounds and
    no masking is needed.  ``shape``/``nnz`` are static aux data so the
    container can flow through ``jit``/``shard_map`` unimpeded.
    """

    cols: jnp.ndarray   # (pr, w) int32
    vals: jnp.ndarray   # (pr, w) dtype
    shape: Tuple[int, int]
    nnz: int

    # pytree protocol ------------------------------------------------------
    def tree_flatten(self):
        return (self.cols, self.vals), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals = children
        shape, nnz = aux
        return cls(cols, vals, shape, nnz)

    # ----------------------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @staticmethod
    def pack_host(
        a: CSR,
        row_multiple: int = 8,
        width_multiple: int = 1,
        pad_rows_to: int | None = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pack a host CSR into padded ELL numpy arrays ``(cols, vals)``."""
        n_rows, n_cols = a.shape
        deg = a.row_degrees
        width = max(int(deg.max()) if n_rows else 1, 1)
        width = _round_up(width, width_multiple)
        pr = _round_up(max(n_rows, 1), row_multiple)
        if pad_rows_to is not None:
            pr = max(pr, pad_rows_to)  # caller-specified row padding

        cols = np.repeat(
            np.arange(pr, dtype=np.int64)[:, None], width, axis=1
        )
        # self-reference padding must stay in-bounds for gathers on x
        np.clip(cols, 0, max(n_cols - 1, 0), out=cols)
        vals = np.zeros((pr, width), dtype=np.float64)

        rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
        # position of each nnz within its row
        pos = np.arange(a.nnz, dtype=np.int64) - np.repeat(a.indptr[:-1], deg)
        cols[rows, pos] = a.indices
        vals[rows, pos] = a.data
        return cols, vals

    @staticmethod
    def from_csr(
        a: CSR,
        dtype=jnp.float64,
        row_multiple: int = 8,
        width_multiple: int = 1,
        pad_rows_to: int | None = None,
    ) -> "Ell":
        """Convert host CSR to padded ELL (host-side packing, one device put)."""
        cols, vals = Ell.pack_host(a, row_multiple, width_multiple, pad_rows_to)
        # cast on host: jnp.asarray(x, dtype=...) would compile+run an XLA
        # convert per distinct shape
        return Ell(
            jnp.asarray(cols.astype(np.int32)),
            jnp.asarray(vals.astype(np.dtype(dtype))),
            a.shape,
            a.nnz,
        )

    def to_csr(self) -> CSR:
        """Device ELL back to host CSR (drops padding zeros)."""
        cols = np.asarray(self.cols)[: self.n_rows]
        vals = np.asarray(self.vals)[: self.n_rows].astype(np.float64)
        rr, pp = np.nonzero(vals != 0.0)
        return CSR.from_coo(rr, cols[rr, pp], vals[rr, pp], self.shape)


# ---------------------------------------------------------------------------
# Device Dense format (small levels)
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Dense:
    """Densified operator for small grid levels.

    Deep AMG levels are small (thousands of rows) but nearly dense
    (hundreds of nnz/row after repeated Galerkin products), which makes
    gather-based sparse formats pointless: a dense matvec streams the
    operator once with zero gathers.  Replaces the
    reference's CSR SpMV (amg/SSS_utils.c:182-201) for levels whose dense
    footprint fits ``AMGParams.dense_level_bytes``.
    """

    vals: jnp.ndarray           # (pr, pc) dtype
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.vals,), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (vals,) = children
        shape, nnz = aux
        return cls(vals, shape, nnz)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.vals.shape[0]

    @property
    def padded_cols(self) -> int:
        return self.vals.shape[1]

    @staticmethod
    def from_csr(
        a: CSR,
        dtype=jnp.float64,
        row_multiple: int = 8,
        pad_rows_to: int | None = None,
        pad_cols_to: int | None = None,
    ) -> "Dense":
        n_rows, n_cols = a.shape
        pr = _round_up(max(n_rows, 1), row_multiple)
        if pad_rows_to is not None:
            pr = max(pr, pad_rows_to)
        pc = _round_up(max(n_cols, 1), 128)  # lane-aligned
        if pad_cols_to is not None:
            pc = max(pc, pad_cols_to)
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), a.row_degrees)
        nd_bytes = pr * pc * np.dtype(dtype).itemsize
        if nd_bytes > _DEVICE_BUILD_BYTES:
            # big array: upload only the nnz triplets and scatter on device
            # ((row, col) pairs are unique in a duplicate-free CSR)
            vals = _device_scatter_2d(
                (pr, pc), rows, a.indices, a.data, dtype
            )
            return Dense(vals, (n_rows, n_cols), a.nnz)
        vals = np.zeros((pr, pc), dtype=np.dtype(dtype))
        vals[rows, a.indices.astype(np.int64)] = a.data
        return Dense(jnp.asarray(vals), (n_rows, n_cols), a.nnz)

    def to_csr(self) -> CSR:
        vals = np.asarray(self.vals, dtype=np.float64)
        sub = vals[: self.n_rows, : self.n_cols]
        rr, cc = np.nonzero(sub)
        return CSR.from_coo(rr, cc, sub[rr, cc], self.shape)


# ---------------------------------------------------------------------------
# Device DIA (diagonal-offset) format
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Dia:
    """Diagonal (offset) storage on device — the fast path for banded
    operators.

    ``vals[d, i] = A[i, i + offsets[d]]`` with a static offset tuple.  SpMV
    is a sum of statically-shifted element-wise products::

        y = sum_d vals[d] * x_padded[L + offsets[d] : L + offsets[d] + n]

    i.e. pure streaming with **no gathers** and no index bytes (see
    ops/spmv.py).  AMG operators from
    stencil problems (and their Galerkin coarse operators) have few distinct
    offsets, so most levels qualify; unstructured levels fall back to
    :class:`Ell`.

    Replaces the reference's thread-per-row CSR kernel
    (amg/Solve/SSS_cuda.cu:77-96) for the structured case.
    """

    vals: jnp.ndarray           # (nd, pad) dtype
    offsets: Tuple[int, ...]    # static
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.vals,), (self.offsets, self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (vals,) = children
        offsets, shape, nnz = aux
        return cls(vals, offsets, shape, nnz)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.vals.shape[1]

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @staticmethod
    def _offset_hist(a: CSR):
        """Memoized (off_lo, uniq offsets) of a host CSR — the (col - row)
        histogram is needed by both format selection (num_offsets, called
        repeatedly per level on embedding candidates) and packing
        (from_csr); one O(nnz) bincount pass serves both."""
        cached = getattr(a, "_off_hist_cache", None)
        if cached is not None and cached[0] == a.nnz:
            return cached[1]
        offs = a.indices - a.row_indices  # int64 result (row_indices i64)
        if len(offs):
            off_lo = int(offs.min())
            cnt = np.bincount(offs - off_lo)
            uniq = np.flatnonzero(cnt) + off_lo
        else:
            off_lo = 0
            uniq = np.zeros(0, dtype=np.int64)
        a._off_hist_cache = (a.nnz, (off_lo, uniq))
        return off_lo, uniq

    @staticmethod
    def num_offsets(a: CSR) -> int:
        """Distinct (col - row) offsets of a host CSR matrix.

        Bincount over the bounded offset range: O(nnz + range), vs the
        O(nnz log nnz) sort inside np.unique (~8s per call at 69M nnz —
        and format selection calls this for every level)."""
        if a.nnz == 0:
            return 0
        return len(Dia._offset_hist(a)[1])

    @staticmethod
    def from_csr(
        a: CSR,
        dtype=jnp.float64,
        row_multiple: int = 8,
        pad_rows_to: int | None = None,
    ) -> "Dia":
        n_rows, n_cols = a.shape
        pr = _round_up(max(n_rows, 1), row_multiple)
        if pad_rows_to is not None:
            pr = max(pr, pad_rows_to)
        rows = a.row_indices
        if a.nnz:
            # bincount + lookup table instead of sort-based unique/searchsorted
            off_lo, uniq = Dia._offset_hist(a)
            offs = a.indices.astype(np.int64) - rows
            lut = np.full(int(uniq[-1]) - off_lo + 1, -1, dtype=np.int64)
            lut[uniq - off_lo] = np.arange(len(uniq))
            dpos = lut[offs - off_lo]
        else:
            uniq = np.zeros(0, dtype=np.int64)
            dpos = np.zeros(0, dtype=np.int64)
        nd_bytes = len(uniq) * pr * np.dtype(dtype).itemsize
        shape = (len(uniq), pr)
        if nd_bytes > _DEVICE_BUILD_BYTES:
            # sparse embedded stencils can be >100x larger than their nnz:
            # upload triplets, scatter on device
            vals = _device_scatter_2d(shape, dpos, rows, a.data, dtype)
        else:
            # build directly in the target dtype; (offset, row) pairs are
            # unique in a duplicate-free CSR, so plain assignment suffices
            vals_np = np.zeros((len(uniq), pr), dtype=np.dtype(dtype))
            vals_np[dpos, rows] = a.data
            vals = jnp.asarray(vals_np)
        return Dia(
            vals,
            tuple(int(o) for o in uniq),
            (n_rows, n_cols),
            a.nnz,
        )

    def to_csr(self) -> CSR:
        vals = np.asarray(self.vals, dtype=np.float64)
        rows_l, cols_l, data_l = [], [], []
        for k, off in enumerate(self.offsets):
            i = np.arange(self.n_rows, dtype=np.int64)
            j = i + off
            m = (j >= 0) & (j < self.n_cols) & (vals[k, : self.n_rows] != 0)
            rows_l.append(i[m])
            cols_l.append(j[m])
            data_l.append(vals[k, : self.n_rows][m])
        return CSR.from_coo(
            np.concatenate(rows_l), np.concatenate(cols_l),
            np.concatenate(data_l), self.shape,
        )


# ---------------------------------------------------------------------------
# Device WEll (windowed-gather ELL) — a format for UNSTRUCTURED rows
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class WEll:
    """Windowed-gather ELL: slot-packed storage for unstructured sparsity.

    Every entry's column is reached through a small, local window of x:

    * rows are processed in **groups of 1024**, viewed as an (8, 128)
      tile: row ``i`` at ``(i//128 % 8, i % 128)``;
    * each group's entries are packed into **slots**; all entries of a
      slot draw x from one 1024-wide column window (``[128*base,
      128*base + 1024)``), with at most one entry per row per slot;
    * an entry's column inside the window is ``128*q + r`` with ``r`` its
      remainder and ``q`` its 128-block.

    The block indices are stored **permuted by remainder**: ``Q[s, j]``
    is the block of the (unique) slot entry in tile row ``s`` whose
    column remainder is ``j``.  The packer enforces the uniqueness
    (entries in one slot and tile row with equal column remainder must
    share the whole column); both are packed into one int16 plane,
    ``loc = (Q[s, l] << 7) | r[s, l]`` (10 bits suffice).

    A bandwidth-reducing row ordering (RCM) keeps windows local so slot
    counts stay near the max row degree.  The format was built for a
    vector unit whose only fast dynamic data movement was the two
    in-tile gathers; whether it still earns its place against plain ELL
    is an open measurement.  Replaces the reference's thread-per-row CSR
    CUDA kernel (amg/Solve/SSS_cuda.cu:77-96) for the unstructured case.
    """

    vals: jnp.ndarray   # (ngroups, S, 8, 128) dtype
    loc: jnp.ndarray    # (ngroups, S, 8, 128) int16: (Q << 7) | r
    base: jnp.ndarray   # (ngroups, S) int32 window start (128-row units)
    shape: Tuple[int, int]
    nnz: int
    pad_cols: int       # x padding the windows were clamped against
    # df64 tail plane (f32, same layout as vals): set by from_csr_df64 —
    # vals + vals_lo reproduces the f64 operator exactly in f64
    vals_lo: Optional[jnp.ndarray] = None
    # ring-halo widths (lo128, hi128) in 128-row units for a
    # groups-sharded multi-chip apply (parallel/halo.well_spmv_ring_local)
    # — static metadata computed at pack time by ring_plan_host
    ring_plan: Optional[Tuple[int, int]] = None

    def tree_flatten(self):
        return (self.vals, self.loc, self.base, self.vals_lo), (
            self.shape, self.nnz, self.pad_cols, self.ring_plan)

    @classmethod
    def tree_unflatten(cls, aux, children):
        vals, loc, base, vals_lo = children
        shape, nnz, pad_cols, ring_plan = aux
        return cls(vals, loc, base, shape, nnz, pad_cols, vals_lo,
                   ring_plan)

    @staticmethod
    def ring_plan_host(base: np.ndarray, vals: np.ndarray, n_shards: int,
                       in_m128: int) -> Tuple[int, int]:
        """Halo widths (lo128, hi128, 128-row units) for a groups-sharded
        apply: shard ``s`` owns row groups ``[s*gps, (s+1)*gps)`` and the
        input-vector block of ``in_m128`` 128-row blocks; every ACTIVE slot's
        window must fall inside ``[s*in_m128 - lo, (s+1)*in_m128 + hi)``.
        Inactive (all-zero) slots are ignored — the packer leaves their
        base at 0, which would otherwise drag ``lo`` to a full-mesh halo.
        Works for rectangular operators (P/R): groups partition the
        OUTPUT rows, ``in_m128`` describes the INPUT blocks."""
        ngroups = base.shape[0]
        if ngroups % n_shards != 0:
            raise ValueError(
                f"ngroups {ngroups} not divisible by {n_shards}")
        gps = ngroups // n_shards
        active = vals.reshape(ngroups, base.shape[1], -1).any(axis=2)
        lo = hi = 0
        for s in range(n_shards):
            act = active[s * gps:(s + 1) * gps]
            if not act.any():
                continue
            bs = base[s * gps:(s + 1) * gps][act]
            lo = max(lo, s * in_m128 - int(bs.min()))
            hi = max(hi, int(bs.max()) + 8 - (s + 1) * in_m128)
        return max(lo, 0), max(hi, 0)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.vals.shape[0] * 1024

    @property
    def n_slots(self) -> int:
        return self.vals.shape[1]

    @staticmethod
    def _pack_greedy_py(a: CSR, pad_cols: int):
        """Greedy first-fit slot packer (reference semantics for the native
        implementation; per-entry Python loop — fine for test-sized
        matrices, the native packer handles production sizes).

        Admission of entry (row, col) into a slot requires, in order:
        (1) ``128*base <= col < 128*base + 1024`` (window fit),
        (2) the row's lane is free in the slot,
        (3) the (tile-row, column-remainder) cell is either free or
            already maps to the same column block — the two-step gather's
            conflict-freedom invariant (see class docstring).
        """
        n = a.n_rows
        ngroups = _round_up(max(n, 1), 1024) // 1024
        base_max = pad_cols // 128 - 8
        per_group = []
        for g in range(ngroups):
            r0, r1 = g * 1024, min((g + 1) * 1024, n)
            lo, hi = int(a.indptr[r0]), int(a.indptr[r1])
            ecols = a.indices[lo:hi].astype(np.int64)
            erows = (np.repeat(np.arange(r0, r1),
                               np.diff(a.indptr[r0:r1 + 1])) - r0)
            evals = a.data[lo:hi]
            order = np.argsort(ecols, kind="stable")
            slots = []  # [base, occupied-rows, rmap {(su, r): q}, entries]
            for e in order:
                c, r = int(ecols[e]), int(erows[e])
                su = r >> 7
                placed = False
                for s in slots:
                    if not (128 * s[0] <= c < 128 * s[0] + 1024):
                        continue
                    if r in s[1]:
                        continue
                    q, rem = divmod(c - 128 * s[0], 128)
                    prev = s[2].get((su, rem))
                    if prev is not None and prev != q:
                        continue
                    s[1].add(r)
                    s[2][(su, rem)] = q
                    s[3].append((r, c, evals[e]))
                    placed = True
                    break
                if not placed:
                    b = min(max(c >> 7, 0), max(base_max, 0))
                    q, rem = divmod(c - 128 * b, 128)
                    slots.append([b, {r}, {(su, rem): q},
                                  [(r, c, evals[e])]])
            per_group.append(slots)
        return per_group

    @staticmethod
    def pack_host(a: CSR, dtype=np.float32, pad_rows_to: int | None = None,
                  pad_cols_to: int | None = None):
        """Pack a host CSR into (vals, loc, base) numpy arrays."""
        n_rows, n_cols = a.shape
        pr = _round_up(max(n_rows, 1), 1024)
        if pad_rows_to is not None:
            pr = max(pr, _round_up(pad_rows_to, 1024))
        pc = _round_up(max(n_cols, 1), 1024)
        if pad_cols_to is not None:
            pc = max(pc, _round_up(pad_cols_to, 1024))
        ngroups = pr // 1024

        try:
            from .native import lib as _native
        except Exception:
            _native = None
        if _native is not None and hasattr(_native, "well_pack"):
            base, loc, vals = _native.well_pack(a, ngroups, pc)
            # native emits the legacy int32 (Q<<16)|r; re-encode to the
            # int16 (Q<<7)|r storage format (lossless: Q<8, r<128)
            loc16 = (((loc >> 16) << 7) | (loc & 0x7F)).astype(np.int16)
            return vals.astype(np.dtype(dtype), copy=False), loc16, base

        per_group = WEll._pack_greedy_py(a, pc)
        S = max(max((len(s) for s in per_group), default=1), 1)
        vals = np.zeros((ngroups, S, 8, 128), dtype=np.dtype(dtype))
        loc = np.zeros((ngroups, S, 8, 128), dtype=np.int16)
        base = np.zeros((ngroups, S), dtype=np.int32)
        for g, slots in enumerate(per_group):
            for k, (b, _, rmap, entries) in enumerate(slots):
                base[g, k] = b
                for (r, c, v) in entries:
                    s, l = r >> 7, r & 127
                    vals[g, k, s, l] = v
                    loc[g, k, s, l] |= (c - 128 * b) & 127
                # Q table: column j of tile row s holds the block of the
                # remainder-j entry (the two-step gather reads it there)
                for (s, rem), q in rmap.items():
                    loc[g, k, s, rem] |= q << 7
        return vals, loc, base

    @staticmethod
    def _plan(base, vals, pc, ring_devices):
        """ring_plan for a pack headed to a D-device shard_map ring (or
        None when the shapes don't divide the mesh)."""
        if not ring_devices or ring_devices < 2:
            return None
        if base.shape[0] % ring_devices or pc % (128 * ring_devices):
            return None
        return WEll.ring_plan_host(base, vals, ring_devices,
                                   pc // 128 // ring_devices)

    @staticmethod
    def from_csr(a: CSR, dtype=jnp.float32, pad_rows_to: int | None = None,
                 pad_cols_to: int | None = None,
                 ring_devices: int | None = None) -> "WEll":
        vals, loc, base = WEll.pack_host(
            a, dtype=np.dtype(dtype), pad_rows_to=pad_rows_to,
            pad_cols_to=pad_cols_to)
        pc = _round_up(max(a.n_cols, 1), 1024)
        if pad_cols_to is not None:
            pc = max(pc, _round_up(pad_cols_to, 1024))
        return WEll(
            jnp.asarray(vals),
            jnp.asarray(loc),
            jnp.asarray(base),
            a.shape,
            a.nnz,
            pc,
            ring_plan=WEll._plan(base, vals, pc, ring_devices),
        )

    @staticmethod
    def from_csr_df64(a: CSR, pad_rows_to: int | None = None,
                      pad_cols_to: int | None = None,
                      ring_devices: int | None = None) -> "WEll":
        """Pack with the operator split into non-overlapping f32 planes
        (vals = f32(v), vals_lo = f32(v - vals)); the apply recombines
        them to the f64 operator."""
        vals64, loc, base = WEll.pack_host(
            a, dtype=np.float64, pad_rows_to=pad_rows_to,
            pad_cols_to=pad_cols_to)
        hi = vals64.astype(np.float32)
        lo = (vals64 - hi.astype(np.float64)).astype(np.float32)
        pc = _round_up(max(a.n_cols, 1), 1024)
        if pad_cols_to is not None:
            pc = max(pc, _round_up(pad_cols_to, 1024))
        return WEll(jnp.asarray(hi), jnp.asarray(loc), jnp.asarray(base),
                    a.shape, a.nnz, pc, vals_lo=jnp.asarray(lo),
                    ring_plan=WEll._plan(base, vals64, pc, ring_devices))

    def to_csr(self) -> CSR:
        vals = np.asarray(self.vals, dtype=np.float64)
        if self.vals_lo is not None:
            vals = vals + np.asarray(self.vals_lo, dtype=np.float64)
        loc = np.asarray(self.loc, dtype=np.int64)
        base = np.asarray(self.base, dtype=np.int64)
        g, k, s, l = np.nonzero(vals)
        rows = g * 1024 + s * 128 + l
        r = loc[g, k, s, l] & 127
        q = loc[g, k, s, r] >> 7      # Q table lives at lane = remainder
        cols = base[g, k] * 128 + q * 128 + r
        keep = rows < self.n_rows
        return CSR.from_coo(rows[keep], cols[keep], vals[g, k, s, l][keep],
                            self.shape)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BandedBlocks:
    """Block-banded dense storage for RCM-ordered levels.

    ``vals[i, d, r, c] = A[128 i + r, 128 (i + d - nb) + c]``: each block
    row ``i`` holds its ``2 nb + 1`` dense 128x128 blocks along the block
    band.  SpMV is ``2 nb + 1`` STATIC shifted slices of x (no gathers)
    feeding one batched block matvec — an alternative to gather-bound
    compact coarse levels (no index bytes, plain streaming).

    Requires the level to be bandwidth-reduced first (reverse
    Cuthill-McKee in ``hierarchy.reorder_for_gs``); the fill cost is
    ``(2 nb + 1) * 128 * pad / nnz`` — bounded by the caller's byte
    budget.  No reference equivalent (the reference's CSR SpMV gathers
    globally, amg/SSS_utils.c:182-201).
    """

    vals: jnp.ndarray          # (nbr, 2*nb+1, 128, 128)
    nb: int                    # static block half-bandwidth
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.vals,), (self.nb, self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (vals,) = children
        nb, shape, nnz = aux
        return cls(vals, nb, shape, nnz)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.vals.shape[0] * 128

    @staticmethod
    def block_bandwidth(a: CSR) -> int:
        """Max |block(col) - block(row)| over the pattern."""
        if a.nnz == 0:
            return 0
        rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), a.row_degrees)
        return int(np.max(np.abs((a.indices.astype(np.int64) >> 7)
                                 - (rows >> 7))))

    @staticmethod
    def from_csr(a: CSR, dtype=jnp.float64, nb: int | None = None,
                 pad_rows_to: int | None = None) -> "BandedBlocks":
        n = a.n_rows
        pad = _round_up(max(n, 1), 128)
        if pad_rows_to is not None:
            pad = max(pad, _round_up(pad_rows_to, 128))
        nbr = pad // 128
        if nb is None:
            nb = BandedBlocks.block_bandwidth(a)
        w = 2 * nb + 1
        rows = np.repeat(np.arange(n, dtype=np.int64), a.row_degrees)
        cols = a.indices.astype(np.int64)
        bi, r = rows >> 7, rows & 127
        d = (cols >> 7) - bi + nb
        if len(d) and (d.min() < 0 or d.max() >= w):
            raise ValueError("entries outside the declared block band")
        c = cols & 127
        lin = ((bi * w + d) * 128 + r) * 128 + c
        flat = np.zeros(nbr * w * 128 * 128, dtype=np.dtype(dtype))
        flat[lin] = a.data
        return BandedBlocks(
            jnp.asarray(flat.reshape(nbr, w, 128, 128)),
            int(nb), a.shape, a.nnz,
        )

    def to_csr(self) -> CSR:
        vals = np.asarray(self.vals, dtype=np.float64)
        nbr, w = vals.shape[0], vals.shape[1]
        bi, d, r, c = np.nonzero(vals)
        rows = bi * 128 + r
        cols = (bi + d - self.nb) * 128 + c
        keep = (rows < self.n_rows) & (cols >= 0) & (cols < self.n_cols)
        return CSR.from_coo(rows[keep], cols[keep],
                            vals[bi, d, r, c][keep], self.shape)
