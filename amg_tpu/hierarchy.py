"""AMG hierarchy: setup driver and device-resident level containers.

Host setup (this module's :func:`setup`) replicates the control flow of the
reference's ``SSS_amg_setup`` (amg/Setup/SSS_SETUP.cu:36-178): loop
coarsening -> interpolation -> R = P^T -> Galerkin RAP, with the same four
break checks and warnings.  The result is then packed once into device
pytrees (:class:`Level` / :class:`Hierarchy`) with static shapes, so the
entire solve phase runs under ``jit`` with zero host<->device traffic.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .params import AMGParams, CoarsenType, InterpType, MIN_CDOF
from .sparse import CSR, Ell, Dia, Dense, BandedBlocks, WEll, _round_up
from .setup_phase.strength import strength_matrix
from .setup_phase.cf_split import rs_split, pmis_split, clean_ff_couplings
from .setup_phase.interp import build_interpolation
from .setup_phase.coloring import build_groups
from .ops.spgemm import rap


# ---------------------------------------------------------------------------
# Device containers
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Level:
    """One device-resident grid level.

    Leaves are device arrays; ``shape`` info and group CF tags are static so
    the container can cross ``jit`` boundaries.  The coarsest level has
    ``p = r = None`` and the hierarchy holds a dense inverse for it.

    The level operator ``a`` is :class:`~amg_tpu.sparse.Dia` when the matrix
    is banded enough (gather-free SpMV and masked-color GS) and
    :class:`~amg_tpu.sparse.Ell` otherwise (group-gather GS).
    """

    a: object                   # Dia | Ell
    p: Optional[Ell]            # prolongation from level l+1 to l
    r: Optional[Ell]            # restriction  from level l to l+1
    diag: jnp.ndarray           # (pad,) a_ii
    inv_diag: jnp.ndarray       # (pad,) 1/a_ii, 0 where |a_ii| tiny
    l1_inv: jnp.ndarray         # (pad,) 1/sum_j |a_ij|
    diag_mask: Optional[jnp.ndarray]  # (pad, w) bool diagonal slots (Ell GS)
    groups: Optional[jnp.ndarray]     # (ng, gs) int32 GS groups (Ell GS)
    gid: Optional[jnp.ndarray]        # (pad,) int32 group id per row (Dia GS)
    rho_dinv_a: jnp.ndarray     # scalar spectral-radius estimate of D^-1 A
    group_cf: Tuple[int, ...]   # static: 1 if group holds C points
    # static (start, size) row range per GS group when the level is
    # color-contiguously ordered (ELL fast path: sweeps are static slices,
    # one SpMV's work total); None -> gather-based group path
    ranges: Optional[Tuple[Tuple[int, int], ...]] = None
    # embedded->compact boundary (set on the deepest fine-grid-embedded
    # level): positions of the next level's rows in this level's embedded
    # index space, padded with an out-of-range index (scatter-dropped)
    compact_idx: Optional[jnp.ndarray] = None
    # compact-boundary alternative (used when embedded P_E/R_E would blow
    # the byte budget, e.g. level-2 embedding at 10M rows): this level's own
    # row positions in the embedded index space.  The boundary then
    # compacts the residual FIRST (one small gather) and applies compact
    # Ell P/R on short vectors, so only A needs the big embedded array.
    member_idx: Optional[jnp.ndarray] = None

    def tree_flatten(self):
        leaves = (self.a, self.p, self.r, self.diag, self.inv_diag,
                  self.l1_inv, self.diag_mask, self.groups, self.gid,
                  self.rho_dinv_a, self.compact_idx, self.member_idx)
        return leaves, (self.group_cf, self.ranges)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves[:-2], group_cf=aux[0], ranges=aux[1],
                   compact_idx=leaves[-2], member_idx=leaves[-1])

    @property
    def n(self) -> int:
        return self.a.n_rows

    @property
    def pad(self) -> int:
        return self.a.padded_rows


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Hierarchy:
    """The full device multigrid hierarchy (reference ``SSS_AMG``)."""

    levels: Tuple[Level, ...]
    coarse_inv: jnp.ndarray      # (pad_c, pad_c) dense inverse of coarsest A

    def tree_flatten(self):
        return (self.levels, self.coarse_inv), ()

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @property
    def num_levels(self) -> int:
        return len(self.levels)


# ---------------------------------------------------------------------------
# Host setup results (kept for printing / tests / distribution)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostHierarchy:
    """Host-side mirror of the hierarchy (CSR matrices + C/F markers)."""

    a: list          # list[CSR], per level
    p: list          # list[CSR], per level except coarsest
    r: list
    cfmark: list     # list[np.ndarray]
    setup_seconds: float = 0.0
    # per level: sorted GS class key per row (color*2 + is_C) when the level
    # has been permuted color-contiguously by :func:`reorder_for_gs`, else None
    gs_key: Optional[list] = None
    # per level: the new->old row permutation applied by reorder_for_gs
    # (None where untouched); consumed by fine-grid embedding at the
    # embedded->compact boundary
    perms: Optional[list] = None
    # per level: block half-bandwidth when the level was RCM-ordered for
    # the BandedBlocks format (None -> not banded)
    banded_nb: Optional[list] = None

    @property
    def num_levels(self) -> int:
        return len(self.a)

    def complexity(self) -> tuple[float, float]:
        grid = sum(m.n_rows for m in self.a) / self.a[0].n_rows
        op = sum(m.nnz for m in self.a) / max(self.a[0].nnz, 1)
        return grid, op


def complexity_print(hh: HostHierarchy) -> str:
    """Level/complexity table with the reference's exact format
    (``SSS_amg_complexity_print``, amg/Setup/SSS_SETUP.cu:5-34)."""
    lines = []
    lines.append("-----------------------------------------------------------")
    lines.append("  Level   Num of rows   Num of nonzeros   Avg. NNZ / row   ")
    lines.append("-----------------------------------------------------------")
    for lvl, m in enumerate(hh.a):
        avg = m.nnz / m.n_rows
        lines.append("%5d %13d %17d %14.2f" % (lvl, m.n_rows, m.nnz, avg))
    lines.append("-----------------------------------------------------------")
    grid, op = hh.complexity()
    lines.append("  Grid complexity = %.3f  |  Operator complexity = %.3f"
                 % (grid, op))
    lines.append("-----------------------------------------------------------")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def setup_host(a: CSR, pars: AMGParams, log=print) -> HostHierarchy:
    """Build the CSR hierarchy on the host.

    Control flow and warnings replicate ``SSS_amg_setup``
    (amg/Setup/SSS_SETUP.cu:69-155) including its four break checks.
    """
    t0 = time.perf_counter()
    min_cdof = max(pars.coarse_dof, MIN_CDOF)
    stop_rows = max(min_cdof, pars.coarse_stop_rows)
    max_lvls = pars.max_levels

    mats = [a]
    ps: list[CSR] = []
    rs: list[CSR] = []
    cfmarks: list[np.ndarray] = []
    cs_type = pars.cs_type

    lvl = 0
    while mats[lvl].n_rows > stop_rows and lvl < max_lvls - 1:
        al = mats[lvl]
        s = strength_matrix(al, pars.strong_threshold, pars.max_row_sum)

        failed = s.nnz <= 0
        vec = None
        agg = None
        col = 0
        if not failed:
            if cs_type == CoarsenType.RS:
                vec, col = rs_split(s)
            elif cs_type == CoarsenType.PMIS:
                # big graphs: run the round loop on the accelerator
                # (segment_max rounds; no host round-trips)
                if al.n_rows >= 262_144:
                    from .setup_phase.cf_split import pmis_split_device

                    vec, col = pmis_split_device(s)
                else:
                    vec, col = pmis_split(s)
            elif cs_type == CoarsenType.SA:
                from .setup_phase.aggregation import aggregate

                agg, col = aggregate(s)
            else:  # RSP falls back to RS (reference leaves RSP unimplemented,
                   # amg/Setup/SSS_coarsen.c:741-743)
                vec, col = rs_split(s)
            if pars.interp_type == InterpType.DIR and col > 0 \
                    and vec is not None:
                col = clean_ff_couplings(s, vec, col)
            failed = col <= 0

        # Check 1: coarsening succeeded? (amg/Setup/SSS_SETUP.cu:78-89)
        if failed:
            if pars.verbose:
                log("### WARNING: Could not find any C-variables!")
                log(f"### WARNING: RS coarsening on level-{lvl} failed!")
            break

        # Check 2: coarse space too small (amg/Setup/SSS_SETUP.cu:92-98)
        if col < min_cdof:
            break

        # Check 3: over-aggressive coarsening warning (:101-106)
        if al.n_rows > col * 10 and pars.verbose:
            log("### WARNING: Coarsening might be too aggressive!")
            log(f"### WARNING: Lvl = {lvl} ,Fine level = {al.n_rows}, "
                f"coarse level = {col}. Discard!")

        # Fall back to RS when coarsening slows (:110)
        if col * 1.5 > al.n_rows:
            cs_type = CoarsenType.RS

        cfmarks.append(vec.copy() if vec is not None else None)

        if agg is not None:
            from .setup_phase.aggregation import sa_interpolation

            p = sa_interpolation(al, agg, col)
        else:
            p = build_interpolation(al, s, vec, col, pars)
        r = p.transpose()
        ac = rap(r, al, p)
        if (pars.coarse_sparsify > 0
                and lvl + 1 >= pars.sparsify_from_level
                and _pick_format(ac, pars) in ("ell", "well")):
            # scope to gather-bound (ELL) levels: dense deep levels
            # cost nothing per extra nnz, so sparsifying them only loses
            # convergence (observed 14 -> 42 FCG its at 10M rows when the
            # whole tail was sparsified)
            ac = sparsify_operator(ac, pars.coarse_sparsify)

        # Check 4: is the coarse matrix too dense? (:142-152)
        # (replicates the reference's integer division on the fine matrix)
        if al.nnz // al.n_rows > al.n_cols * 0.2:
            if pars.verbose:
                log("### WARNING: Coarse matrix is too dense!")
                log(f"### WARNING: m = n = {al.n_cols}, nnz = {al.nnz}!")
            break

        ps.append(p)
        rs.append(r)
        mats.append(ac)
        lvl += 1

    hh = HostHierarchy(a=mats, p=ps, r=rs, cfmark=cfmarks)
    hh.setup_seconds = time.perf_counter() - t0
    return hh


def reorder_for_gs(hh: HostHierarchy, pars: AMGParams,
                   skip_levels: int = 0) -> HostHierarchy:
    """Permute coarse ELL-format levels color-contiguously (in place).

    Rows of each level ``l >= 1`` destined for the gather-based ELL format
    are reordered by ``(color, C/F)`` so every multicolor-GS class is a
    contiguous row range: a GS sweep then costs one SpMV's worth of static
    slices instead of ``n_groups`` padded gathers.  The permutation is a
    similarity transform (``P A P^T`` plus matching P/R/cfmark updates), so
    the hierarchy's numerics are unchanged; only the internal ordering of
    coarse unknowns differs.  Level 0 keeps the user's ordering.
    """
    from .params import CGPT
    from .setup_phase.coloring import color_graph

    banded_on = pars.use_banded == "on" or (
        pars.use_banded == "auto"
        and (jax.device_count() == 1 or pars.dist_devices > 1)
    )
    op_itemsize = np.dtype(
        pars.dtype if pars.coarse_op_dtype == "same" else pars.coarse_op_dtype
    ).itemsize

    nl = hh.num_levels
    hh.gs_key = [None] * nl
    hh.perms = [None] * nl
    hh.banded_nb = [None] * nl
    if skip_levels == 0:
        reorder_l0_for_well(hh, pars)
    for l in range(max(1, skip_levels + 1), nl):
        al = hh.a[l]
        if _pick_format(al, pars) == "dia":
            continue
        n = al.n_rows

        perm = None
        clip_nb = None
        fmt_l = _pick_format(al, pars)
        if banded_on and fmt_l in ("ell", "dense", "well") and l < nl - 1:
            # try the block-banded layout: RCM to shrink the block
            # bandwidth, accept if the dense band fits the byte budget.
            # For dense-eligible levels only switch when the band is
            # clearly leaner than the full square (same exactness,
            # proportionally less HBM traffic per apply).
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            m = sp.csr_matrix((al.data, al.indices, al.indptr),
                              shape=al.shape)
            rcm = np.asarray(
                reverse_cuthill_mckee(m, symmetric_mode=True),
                dtype=np.int64,
            )
            al_rcm = al.permute(rcm)
            nb = BandedBlocks.block_bandwidth(al_rcm)
            nbr = _round_up(max(n, 1), 128) // 128
            band_bytes = nbr * (2 * nb + 1) * 128 * 128 * op_itemsize
            dense_bytes = (nbr * 128) ** 2 * op_itemsize
            fits = band_bytes <= pars.banded_level_bytes and (
                fmt_l == "ell"
                # vs WEll: banded streams its dense band (~88% SoL), WEll
                # ~20-36 B/nnz (~65% SoL) — prefer banded only while its
                # band is lean enough per nnz to come out ahead
                or (fmt_l == "well" and band_bytes <= 40 * al.nnz)
                or (fmt_l == "dense" and 2 * band_bytes <= dense_bytes)
            )
            if fits:
                perm = rcm
                hh.banded_nb[l] = nb
            elif pars.banded_clip_frac > 0 and fmt_l == "ell":
                # the band overshoots the budget: clip at the largest nb
                # that fits and lump the out-of-band tail into the
                # diagonal, if that tail is a small fraction of nnz
                per_w = nbr * 128 * 128 * op_itemsize
                nb_fit = int((pars.banded_level_bytes / per_w - 1) // 2)
                if nb_fit >= 1:
                    rows = np.repeat(
                        np.arange(n, dtype=np.int64), al_rcm.row_degrees)
                    bd = np.abs(
                        (al_rcm.indices.astype(np.int64) >> 7) - (rows >> 7))
                    frac = float(np.count_nonzero(bd > nb_fit)) \
                        / max(al_rcm.nnz, 1)
                    if frac <= pars.banded_clip_frac:
                        perm = rcm
                        hh.banded_nb[l] = nb_fit
                        clip_nb = nb_fit

        if perm is None and fmt_l == "well":
            # WEll level: order rows for slot-window locality, NOT by
            # color (a color-contiguous order scatters neighbors and
            # blows up the slot count / SMEM base table).  Use the
            # ordering induced by the parent level — each unknown at its
            # interpolation barycenter — so A_l, P_{l-1} and R_{l-1} all
            # stay window-local without a fresh RCM pass.  GS smoothing
            # on these levels runs masked (full SpMV + class mask).
            perm = _barycentric_order(hh.p[l - 1])
        elif perm is None:
            if not _needs_groups(pars, True):
                # no GS-family smoother on this level: the color-contiguous
                # permutation (and the coloring itself) buys nothing
                continue
            colors = color_graph(al)
            cf = hh.cfmark[l] if l < len(hh.cfmark) else None
            is_c = (
                (np.asarray(cf) == CGPT).astype(np.int64)
                if cf is not None
                else np.zeros(n, dtype=np.int64)
            )
            key = colors.astype(np.int64) * 2 + is_c
            perm = np.argsort(key, kind="stable")  # new -> old
            hh.gs_key[l] = key[perm]
        if not np.array_equal(perm, np.arange(n, dtype=np.int64)):
            hh.perms[l] = perm
            inv = np.empty_like(perm)
            inv[perm] = np.arange(n, dtype=np.int64)
            hh.a[l] = al.permute(perm)
            hh.p[l - 1] = hh.p[l - 1].permute_cols(inv)
            hh.r[l - 1] = hh.r[l - 1].permute_rows(perm)
            if l < nl - 1:
                hh.p[l] = hh.p[l].permute_rows(perm)
                hh.r[l] = hh.r[l].permute_cols(inv)
            if l < len(hh.cfmark) and hh.cfmark[l] is not None:
                hh.cfmark[l] = np.asarray(hh.cfmark[l])[perm]
        if clip_nb is not None:
            hh.a[l] = clip_to_band(hh.a[l], clip_nb)
    return hh


def reorder_l0_for_well(hh: HostHierarchy, pars: AMGParams) -> None:
    """RCM-permute level 0 when it is headed for the WEll format.

    WEll slot counts (and with them HBM traffic and the SMEM base-table
    size) scale with how far a row's couplings stray from its 1024-wide
    x windows, so an unstructured level 0 must be bandwidth-reduced
    before packing.  Unlike the coarse-level permutations this one is
    visible at the API boundary: the driver permutes b/x0 on entry and
    inverts on exit (``hh.perms[0]``).  Numerics are unchanged (similarity
    transform, norms invariant).
    """
    a0 = hh.a[0]
    if _pick_format(a0, pars) != "well":
        return
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = sp.csr_matrix((a0.data, a0.indices, a0.indptr), shape=a0.shape)
    perm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                      dtype=np.int64)
    if np.array_equal(perm, np.arange(a0.n_rows, dtype=np.int64)):
        return
    if hh.perms is None:
        hh.perms = [None] * hh.num_levels
    hh.perms[0] = perm
    inv = np.empty_like(perm)
    inv[perm] = np.arange(a0.n_rows, dtype=np.int64)
    hh.a[0] = a0.permute(perm)
    if hh.num_levels > 1:
        hh.p[0] = hh.p[0].permute_rows(perm)
        hh.r[0] = hh.r[0].permute_cols(inv)
    if len(hh.cfmark) > 0 and hh.cfmark[0] is not None:
        hh.cfmark[0] = np.asarray(hh.cfmark[0])[perm]


def _barycentric_order(p: CSR) -> np.ndarray:
    """Locality ordering of a coarse level induced by its parent: place
    each coarse unknown at the |P|-weighted mean of its fine rows'
    positions and sort.  Keeps A_l, P_{l-1}, R_{l-1} window-local when
    the parent is already bandwidth-reduced (level-0 RCM cascades down
    the hierarchy without per-level RCM passes)."""
    w = np.abs(p.data)
    rows = p.row_indices.astype(np.float64)
    cols = p.indices.astype(np.int64)
    nc = p.n_cols
    wsum = np.bincount(cols, weights=w, minlength=nc)
    wpos = np.bincount(cols, weights=w * rows, minlength=nc)
    pos = np.where(wsum > 0, wpos / np.maximum(wsum, 1e-300), 0.0)
    return np.argsort(pos, kind="stable").astype(np.int64)


def clip_to_band(a: CSR, nb: int) -> CSR:
    """Drop entries outside the block band ``|block(j) - block(i)| <= nb``
    and lump them into the diagonal (row sums preserved) — the geometric
    cousin of :func:`sparsify_operator`, used when an RCM band slightly
    overshoots the BandedBlocks byte budget."""
    n = a.n_rows
    rows = a.row_indices
    cols = a.indices.astype(np.int64)
    keep = np.abs((cols >> 7) - (rows >> 7)) <= nb
    lump = np.bincount(rows[~keep], weights=a.data[~keep], minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.bincount(rows[keep], minlength=n)
    np.cumsum(indptr, out=indptr)
    data = a.data[keep].copy()
    new_cols = cols[keep].astype(np.int32)
    kept_rows = rows[keep]
    is_diag = new_cols == kept_rows
    data[is_diag] += lump[kept_rows[is_diag]]
    return CSR(indptr, new_cols, data, a.shape)


# ---------------------------------------------------------------------------
# Fine-grid embedding of coarse levels
#
# Opt-in alternative to the compact (renumbered) coarse representation,
# whose P/R/A applications all gather: coarse unknowns KEEP their
# level-0 grid positions: every coarse operator becomes a diagonal-offset
# stencil (Dia) over the fine grid and the entire cycle runs gather-free.
# Coarse vectors are fine-grid length with zeros at non-member positions
# (inv_diag masks keep smoothers exact).  Embedding stops when the stencil
# outgrows `embed_max_diags`/budget; deeper levels use compact formats with
# one gather/scatter pair at the boundary.
# ---------------------------------------------------------------------------


def _embed_csr(m: CSR, row_emb: np.ndarray, col_emb: np.ndarray,
               n0: int) -> CSR:
    """Re-index a compact operator into the fine (level-0) index space."""
    deg = m.row_degrees
    cols = col_emb[m.indices.astype(np.int64)]
    if m.n_rows == 0 or np.all(np.diff(row_emb) > 0):
        # row map strictly increasing (the common case: embedding positions
        # are sorted C-point lists): rows stay in CSR order, so build the
        # row pointer directly instead of lexsorting nnz entries
        indptr = np.zeros(n0 + 1, dtype=np.int64)
        indptr[row_emb.astype(np.int64) + 1] = deg
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, cols.astype(np.int32), m.data.copy(), (n0, n0))
    return CSR.from_coo(row_emb[m.row_indices], cols, m.data, (n0, n0))


def _embedded_offset_hist(m: CSR, row_emb, col_emb, cache=None):
    """(off_lo, uniq) histogram of embedded (col - row) offsets, memoized.

    ``embedding_plan`` counts these for every candidate operator, and
    ``_embedded_level`` needs the identical histogram again when packing —
    at 10M rows each recount is ~4 passes over a 69M-entry array, so the
    plan phase shares one pass with the pack phase through ``cache``
    (keyed by object identity, which is stable within one setup)."""
    key = (id(m), id(row_emb), id(col_emb))
    if cache is not None and key in cache:
        return cache[key]
    rows = m.row_indices
    # index with the int32 indices directly: the astype(int64) allocated
    # a full 8-byte copy of a 69M-entry array per call (profiled 8.5 s
    # of the 10M plan phase)
    off = col_emb[m.indices] - row_emb[rows]
    if len(off) == 0:
        hist = (0, np.zeros(0, dtype=np.int64))
    else:
        # bincount over the bounded offset range is O(nnz + range), much
        # faster than the sort inside np.unique at multi-million nnz
        lo = int(off.min())
        uniq = np.flatnonzero(np.bincount(off - lo)) + lo
        hist = (lo, uniq)
    if cache is not None:
        cache[key] = hist
    return hist


def _num_offsets_embedded(m: CSR, row_emb, col_emb, cache=None) -> int:
    return len(_embedded_offset_hist(m, row_emb, col_emb, cache)[1])


def _embed_csr_cached(m: CSR, row_emb, col_emb, n0: int, cache) -> CSR:
    """_embed_csr + pre-seed the result's (col-row) histogram from the
    plan-phase cache so Dia.num_offsets / Dia.from_csr skip their own
    recount passes over the (potentially 100x-expanded) embedded nnz."""
    out = _embed_csr(m, row_emb, col_emb, n0)
    out._off_hist_cache = (
        out.nnz, _embedded_offset_hist(m, row_emb, col_emb, cache))
    return out


def resolved_embed_levels(pars: AMGParams) -> int:
    """Resolve ``pars.embed_levels`` (-1 = auto = no embedding).

    Fine-grid embedding trades gathers for streamed wide-DIA stencils.
    Gathers are ordinary work on the GPU, and the embedded layout is far
    slower for XLA to compile, so auto resolves to 0 on every backend;
    an explicit value forces it.
    """
    return max(pars.embed_levels, 0)


def embedding_plan(hh: HostHierarchy, pars: AMGParams):
    """Decide how deep the fine-grid embedding goes.

    Returns ``(E, emb, boundary)`` where ``emb[l]`` maps level-l rows to
    level-0 positions, levels ``1..E`` (plus level-0's P/R) are embedded,
    and ``boundary`` is how level E hands off to the compact world:
    ``"embedded"`` (fine-grid P_E/R_E streams) or ``"compact"`` (compact
    the residual first, then small Ell P/R — only A_E needs the embedded
    array, which is what keeps deep embedding affordable at 10M+ rows).
    ``E = 0`` means no embedding (compact formats everywhere).
    """
    from .params import CGPT

    nl = hh.num_levels
    n0 = hh.a[0].n_rows
    hist_cache = hh.__dict__.setdefault("_emb_hist", {})
    emb = [np.arange(n0, dtype=np.int64)]
    for cf in hh.cfmark:
        if cf is None:
            # aggregation levels: coarse unknowns are aggregates, not
            # fine-grid points — no fine-grid embedding possible
            return 0, emb, None
        cpos = np.flatnonzero(np.asarray(cf) == CGPT)
        emb.append(emb[len(emb) - 1][cpos])

    embed_levels = resolved_embed_levels(pars)
    if embed_levels <= 0 or nl < 2:
        return 0, emb, None
    # level 0 must itself be a banded (Dia) operator for stencil embedding
    if _pick_format(hh.a[0], pars) != "dia":
        return 0, emb, None

    itemsize = np.dtype(
        pars.dtype if pars.coarse_op_dtype == "same" else pars.coarse_op_dtype
    ).itemsize
    budget = pars.embed_max_bytes
    # with a Gauss-Seidel-family smoother, a masked sweep on an embedded
    # level costs (and compiles) n_colors full operator passes — cap
    # n_groups * n_diags; SpMV-based smoothers (Chebyshev/Jacobi) don't care
    from .params import SmootherType

    coarse_sm = pars.coarse_smoother or pars.smoother
    gs_like = coarse_sm in (
        SmootherType.GS, SmootherType.SGS, SmootherType.SOR,
        SmootherType.SSOR, SmootherType.GSOR, SmootherType.SGSOR,
    )
    gs_cap = 1500

    E = 0
    spent = 0.0
    # level l is embeddable if A_l, P_{l-1}, R_{l-1} all stay within the
    # stencil cap; the coarsest level always stays compact (dense inverse)
    for l in range(1, min(embed_levels + 1, nl - 1)):
        if l >= len(emb):
            break
        nd_a = _num_offsets_embedded(hh.a[l], emb[l], emb[l], hist_cache)
        nd_p = _num_offsets_embedded(hh.p[l - 1], emb[l - 1], emb[l],
                                     hist_cache)
        nd_r = _num_offsets_embedded(hh.r[l - 1], emb[l], emb[l - 1],
                                     hist_cache)
        if max(nd_a, nd_p, nd_r) > pars.embed_max_diags:
            break
        if gs_like:
            from .setup_phase.coloring import color_graph

            colors = color_graph(hh.a[l])
            ngroups = (int(colors.max()) + 1 if len(colors) else 1) * 2
            if ngroups * nd_a > gs_cap:
                break
        cost = (nd_a + nd_p + nd_r) * n0 * itemsize
        if spent + cost > budget:
            break
        spent += cost
        E = l
    boundary = None
    if E >= 1:
        # the boundary level needs either embedded P_E/R_E (streaming, but
        # (nd_p + nd_r) * n0 bytes) or the compact handoff (small gather +
        # compact Ell P/R — no extra embedded arrays at all)
        nd_p = _num_offsets_embedded(hh.p[E], emb[E], emb[E + 1], hist_cache)
        nd_r = _num_offsets_embedded(hh.r[E], emb[E + 1], emb[E], hist_cache)
        cost = (nd_p + nd_r) * n0 * itemsize
        emb_fits = (max(nd_p, nd_r) <= pars.embed_max_diags
                    and spent + cost <= budget)
        if pars.embed_boundary == "compact":
            boundary = "compact"
        elif emb_fits:
            boundary = "embedded"
        elif pars.embed_boundary == "auto":
            boundary = "compact"
        else:  # forced "embedded" but it doesn't fit: shrink the embedding
            E -= 1
            boundary = "embedded" if E >= 1 else None
    return E, emb, boundary


def _embedded_level(
    hh: HostHierarchy,
    l: int,
    E: int,
    emb: list,
    pad0: int,
    pad_next: Optional[int],
    dtype,
    pars: AMGParams,
    boundary: str = "embedded",
) -> Level:
    """Build a fine-grid-embedded device level (all operators Dia)."""
    from .params import SMALLFLOAT, SmootherType

    al = hh.a[l]
    n0 = hh.a[0].n_rows
    nl = hh.num_levels
    rl = emb[l]

    # coarse-level operator values may use reduced-precision storage
    op_dtype = dtype if (l == 0 or pars.coarse_op_dtype == "same") \
        else jnp.dtype(pars.coarse_op_dtype)

    if l == 0:
        a_dev = Dia.from_csr(al, dtype=dtype, pad_rows_to=pad0) \
            if _pick_format(al, pars) == "dia" else None
        if a_dev is None:
            raise ValueError("embedded hierarchy requires a banded A_0")
    else:
        hist_cache = hh.__dict__.setdefault("_emb_hist", {})
        a_emb = _embed_csr_cached(al, rl, rl, n0, hist_cache)
        a_dev = Dia.from_csr(a_emb, dtype=op_dtype, pad_rows_to=pad0)

    p_dev = r_dev = None
    compact_idx = None
    member_idx = None
    if l == E and l < nl - 1 and boundary == "compact":
        # compact handoff: no embedded P_E/R_E at all.  The cycle gathers
        # the residual at this level's member positions (a small n_E-sized
        # gather), applies compact Ell R/P on short vectors, and
        # scatter-adds the prolonged correction back.
        pad_self = _round_up(max(al.n_rows, 1), 8)
        p_dev = Ell.from_csr(hh.p[l], dtype=dtype, pad_rows_to=pad_self)
        r_dev = Ell.from_csr(hh.r[l], dtype=dtype, pad_rows_to=pad_next)
        idx = np.full(pad_self, pad0, dtype=np.int64)
        idx[: len(rl)] = rl
        member_idx = jnp.asarray(idx.astype(np.int32))
    elif l < nl - 1:
        cl = emb[l + 1]
        pr_dtype = dtype if pars.coarse_op_dtype == "same" \
            else jnp.dtype(pars.coarse_op_dtype)
        hist_cache = hh.__dict__.setdefault("_emb_hist", {})
        p_emb = _embed_csr_cached(hh.p[l], rl, cl, n0, hist_cache)
        r_emb = _embed_csr_cached(hh.r[l], cl, rl, n0, hist_cache)
        p_dev = Dia.from_csr(p_emb, dtype=pr_dtype, pad_rows_to=pad0)
        r_dev = Dia.from_csr(r_emb, dtype=pr_dtype, pad_rows_to=pad0)
        if l == E:
            # boundary to the compact world: next level's rows live at
            # emb positions; padding points out of range (dropped)
            idx = np.full(pad_next, pad0, dtype=np.int64)
            idx[: len(cl)] = cl
            compact_idx = jnp.asarray(idx.astype(np.int32))

    n = al.n_rows
    diag_c = al.diagonal_fast()
    diag = np.zeros(pad0)
    diag[rl] = diag_c
    inv_diag = np.zeros(pad0)
    nz = np.abs(diag_c) > SMALLFLOAT
    inv_diag[rl[nz]] = 1.0 / diag_c[nz]

    l1_c = _row_abs_sums(al)
    l1_inv = np.zeros(pad0)
    nz1 = l1_c > SMALLFLOAT
    l1_inv[rl[nz1]] = 1.0 / l1_c[nz1]

    cfmark = hh.cfmark[l] if l < len(hh.cfmark) else None
    if _needs_groups(pars, l >= 1):
        groups, group_cf, gid_c = build_groups(al, cfmark, pad_to=pad0)
        gid = np.full(pad0, -1, dtype=np.int32)
        gid[rl] = gid_c[:n]
        gid_dev = jnp.asarray(gid)
    else:
        group_cf = ()
        gid_dev = None

    lvl_smoother = pars.smoother if (l == 0 or pars.coarse_smoother is None) \
        else pars.coarse_smoother
    rho = 1.0
    if lvl_smoother in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        rho = _rho_dinv_a_host(al)

    return Level(
        a=a_dev,
        p=p_dev,
        r=r_dev,
        diag=jnp.asarray(diag.astype(np.dtype(dtype))),
        inv_diag=jnp.asarray(inv_diag.astype(np.dtype(dtype))),
        l1_inv=jnp.asarray(l1_inv.astype(np.dtype(dtype))),
        diag_mask=None,
        groups=None,
        gid=gid_dev,
        rho_dinv_a=jnp.asarray(rho, dtype=dtype),
        group_cf=tuple(int(t) for t in group_cf),
        ranges=None,
        compact_idx=compact_idx,
        member_idx=member_idx,
    )


def sparsify_operator(a: CSR, threshold: float) -> CSR:
    """Non-Galerkin coarse-operator sparsification.

    Drop entries with ``|a_ij| < threshold * sqrt(|a_ii a_jj|)`` and lump
    the dropped mass into the diagonal (row sums preserved) — the
    standard remedy for Galerkin stencil growth (RS-AMG coarse operators
    reach hundreds of nnz/row at depth, and each nnz of a compact level
    is a gather).  No reference equivalent: the reference keeps
    exact Galerkin operators (amg/SSS_matvec.c:398) but only ever runs
    small problems.
    """
    n = a.n_rows
    d = a.diagonal_fast()
    rows = a.row_indices
    cols = a.indices.astype(np.int64)
    scale = np.sqrt(np.abs(d[rows]) * np.abs(d[cols]))
    keep = (rows == cols) | (np.abs(a.data) >= threshold * scale)
    lump = np.bincount(rows[~keep], weights=a.data[~keep], minlength=n)

    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.bincount(rows[keep], minlength=n)
    np.cumsum(indptr, out=indptr)
    data = a.data[keep].copy()
    new_cols = cols[keep].astype(np.int32)
    # add the lumped mass onto each row's diagonal slot
    kept_rows = rows[keep]
    is_diag = new_cols == kept_rows
    data[is_diag] += lump[kept_rows[is_diag]]
    return CSR(indptr, new_cols, data, a.shape)


def _needs_groups(pars: AMGParams, is_coarse: bool) -> bool:
    """GS update groups (graph coloring) are only consumed by the
    GS-family smoothers; Chebyshev/Jacobi/L1 levels skip the coloring
    entirely (the native greedy pass is O(nnz) — seconds per level at
    10M rows)."""
    from .params import SmootherType

    sm = pars.smoother if (not is_coarse or pars.coarse_smoother is None) \
        else pars.coarse_smoother
    return sm in (
        SmootherType.GS, SmootherType.SGS, SmootherType.SOR,
        SmootherType.SSOR, SmootherType.GSOR, SmootherType.SGSOR,
        SmootherType.CG,
    )


def _row_abs_sums(al: CSR) -> np.ndarray:
    """sum_j |a_ij| per row — reduceat over the CSR entry stream (np.add.at
    is unbuffered and ~50x slower at tens of millions of entries)."""
    out = np.zeros(al.n_rows)
    nonempty = al.row_degrees > 0
    starts = al.indptr[:-1][nonempty]
    if len(starts):
        out[nonempty] = np.add.reduceat(np.abs(al.data), starts)
    return out


def _rho_dinv_a_host(al: CSR, niter: int = 12) -> float:
    """Spectral-radius estimate of ``D^{-1} A`` by host power iteration.

    Runs on the host with a scipy CSR matvec: O(niter * nnz) — far cheaper
    than compiling a per-level device program for a one-shot setup-time
    scalar (each XLA compile costs ~1s; at 1M rows the fleet of per-level
    power-iteration programs dominated ``to_device``).  Only the
    Chebyshev/polynomial smoothers consume the result.
    """
    import scipy.sparse as sp

    from .params import SMALLFLOAT

    n = al.n_rows
    if n == 0:
        return 1.0
    d = al.diagonal_fast()
    dinv = np.where(np.abs(d) > SMALLFLOAT,
                    1.0 / np.where(d != 0, d, 1.0), 0.0)
    m = sp.csr_matrix((al.data, al.indices, al.indptr), shape=al.shape)
    v = np.random.default_rng(0).random(n)
    rho = 1.0
    for _ in range(niter):
        w = dinv * (m @ v)
        nw = float(np.linalg.norm(w))
        nv = float(np.linalg.norm(v))
        if nw <= 0.0 or nv <= 0.0:
            break
        rho = nw / nv
        v = w / nw
    return float(rho)


def _use_dia(al: CSR, pars: AMGParams) -> bool:
    """Pick the DIA fast path when the operator is banded enough: few
    distinct (col-row) offsets and acceptable zero-fill."""
    if al.n_rows != al.n_cols:
        return False
    nd = Dia.num_offsets(al)
    if nd > pars.max_diags:
        return False
    fill = nd * al.n_rows / max(al.nnz, 1)
    return fill <= pars.max_dia_fill


def _pick_format(al: CSR, pars: AMGParams) -> str:
    """Device format for a level operator: 'dia'|'dense'|'well'|'ell'.

    DIA (gather-free streaming) when banded; Dense (matvec, zero gathers)
    when the dense footprint fits the budget — deep levels are small but
    nearly dense; WEll (windowed-gather ELL) for large unstructured
    levels; padded-ELL gathers otherwise.
    """
    if _use_dia(al, pars):
        return "dia"
    itemsize = np.dtype(pars.dtype).itemsize
    if al.n_rows == al.n_cols and (
        al.n_rows * al.n_cols * itemsize <= pars.dense_level_bytes
    ):
        return "dense"
    well_on = pars.use_well == "on" or (
        pars.use_well == "auto"
        and (jax.device_count() == 1 or pars.dist_devices > 1)
    )
    if well_on and al.n_rows >= pars.well_min_rows:
        return "well"
    return "ell"


def _level_from_csr(
    al: CSR,
    p: Optional[CSR],
    r: Optional[CSR],
    cfmark: Optional[np.ndarray],
    pad: int,
    pad_coarse: Optional[int],
    dtype,
    pars: AMGParams,
    gs_key: Optional[np.ndarray] = None,
    is_coarse: bool = False,
    banded_nb: Optional[int] = None,
) -> Level:
    from .params import SMALLFLOAT

    fmt = _pick_format(al, pars)
    if banded_nb is not None and fmt in ("ell", "dense", "well"):
        fmt = "banded"
    op_dtype = dtype if (not is_coarse or pars.coarse_op_dtype == "same") \
        else jnp.dtype(pars.coarse_op_dtype)
    ell_cols_np = ell_vals_np = None
    if fmt == "dia":
        a_dev = Dia.from_csr(al, dtype=op_dtype, pad_rows_to=pad)
    elif fmt == "banded":
        a_dev = BandedBlocks.from_csr(al, dtype=op_dtype, nb=banded_nb,
                                      pad_rows_to=pad)
    elif fmt == "dense":
        a_dev = Dense.from_csr(al, dtype=op_dtype, pad_rows_to=pad,
                               pad_cols_to=pad)
    elif fmt == "well":
        a_dev = WEll.from_csr(al, dtype=op_dtype, pad_rows_to=pad,
                              pad_cols_to=pad,
                              ring_devices=pars.dist_devices)
    else:
        ell_cols_np, ell_vals_np = Ell.pack_host(al, pad_rows_to=pad)
        a_dev = Ell(
            jnp.asarray(ell_cols_np.astype(np.int32)),
            jnp.asarray(ell_vals_np.astype(np.dtype(dtype))),
            al.shape,
            al.nnz,
        )
    # transfer operators: on WEll levels P/R would otherwise gather from
    # large vectors (the XLA scalar-loop path) — pack them as WEll too.
    # Output lengths must match the level pads exactly, so WEll (which
    # pads rows to 1024) applies only when the pad is 1024-aligned.
    tr_dtype = dtype if pars.transfer_op_dtype == "same" \
        else jnp.dtype(pars.transfer_op_dtype)
    if p is not None and fmt == "well" and pad % 1024 == 0:
        p_ell = WEll.from_csr(p, dtype=tr_dtype, pad_rows_to=pad,
                              pad_cols_to=pad_coarse,
                              ring_devices=pars.dist_devices)
    elif p is not None:
        p_ell = Ell.from_csr(p, dtype=dtype, pad_rows_to=pad)
    else:
        p_ell = None
    if r is not None and fmt == "well" and pad_coarse is not None \
            and pad_coarse % 1024 == 0:
        r_ell = WEll.from_csr(r, dtype=tr_dtype, pad_rows_to=pad_coarse,
                              pad_cols_to=pad,
                              ring_devices=pars.dist_devices)
    elif r is not None:
        r_ell = Ell.from_csr(r, dtype=dtype, pad_rows_to=pad_coarse)
    else:
        r_ell = None

    n = al.n_rows
    diag = np.zeros(pad)
    diag[:n] = al.diagonal_fast()
    inv_diag = np.where(np.abs(diag) > SMALLFLOAT, 1.0 / np.where(diag != 0, diag, 1.0), 0.0)

    l1 = np.zeros(pad)
    l1[:n] = _row_abs_sums(al)
    l1_inv = np.where(l1 > SMALLFLOAT, 1.0 / np.where(l1 != 0, l1, 1.0), 0.0)

    diag_mask = None
    groups_dev = None
    gid_dev = None
    ranges = None
    if fmt == "ell":
        # mark diagonal slots in the ELL layout (host-side numpy)
        row_ids = np.arange(a_dev.padded_rows)[:, None]
        diag_mask = jnp.asarray((ell_cols_np == row_ids) & (ell_vals_np != 0))
    if not _needs_groups(pars, is_coarse):
        group_cf = ()
    elif gs_key is not None and n and np.all(np.diff(gs_key) >= 0):
        # color-contiguous fast path: GS groups are static row ranges
        # (level permuted by reorder_for_gs); key = color*2 + is_C
        bnd = np.flatnonzero(np.diff(gs_key)) + 1
        starts = np.concatenate([[0], bnd])
        ends = np.concatenate([bnd, [n]])
        ranges = tuple(
            (int(s), int(e - s)) for s, e in zip(starts, ends)
        )
        group_cf = [int(gs_key[s] % 2) for s in starts]
    elif fmt in ("dia", "dense", "banded", "well"):
        # gather-free masked GS path (full-operator product + class mask)
        groups, group_cf, gid = build_groups(al, cfmark, pad_to=pad)
        gid_dev = jnp.asarray(np.asarray(gid, dtype=np.int32))
    else:
        # gather-based group path (unpermuted ELL levels, e.g. level 0)
        groups, group_cf, gid = build_groups(al, cfmark, pad_to=pad)
        groups_dev = jnp.asarray(np.asarray(groups, dtype=np.int32))

    # spectral radius of D^{-1} A (host power iteration; only the
    # Chebyshev/poly smoothers consume it).  The coarse-smoother override
    # applies on coarse levels, same as the cycle's dispatch.
    from .params import SmootherType

    lvl_smoother = pars.smoother if (not is_coarse or
                                     pars.coarse_smoother is None) \
        else pars.coarse_smoother
    rho = 1.0
    if lvl_smoother in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        rho = _rho_dinv_a_host(al)
    return Level(
        a=a_dev,
        p=p_ell,
        r=r_ell,
        diag=jnp.asarray(diag.astype(np.dtype(dtype))),
        inv_diag=jnp.asarray(inv_diag.astype(np.dtype(dtype))),
        l1_inv=jnp.asarray(l1_inv.astype(np.dtype(dtype))),
        diag_mask=diag_mask,
        groups=groups_dev,
        gid=gid_dev,
        rho_dinv_a=jnp.asarray(rho, dtype=dtype),
        group_cf=tuple(int(t) for t in group_cf),
        ranges=ranges,
    )


def to_device(hh: HostHierarchy, pars: AMGParams,
              plan=None) -> Hierarchy:
    """Pack the host hierarchy into device pytrees."""
    dtype = jnp.dtype(pars.dtype)
    nl = hh.num_levels
    if plan is None:
        plan = embedding_plan(hh, pars)
    E, emb = plan[0], plan[1]
    boundary = plan[2] if len(plan) > 2 else ("embedded" if E else None)
    # the first compact level may have been color-permuted after the plan
    # was computed; carry the permutation into its fine-position map so the
    # boundary operators (P_E/R_E, compact_idx) index it correctly
    if E >= 1 and hh.perms is not None and E + 1 < nl \
            and hh.perms[E + 1] is not None:
        emb = list(emb)
        emb[E + 1] = emb[E + 1][hh.perms[E + 1]]
    # dense/banded levels pad to the 128-lane boundary so the level's
    # vectors are directly usable as (block) matvec operands; WEll levels
    # pad to the 1024-row group size; embedded levels share level 0's pad
    fmts = [
        "banded" if (hh.banded_nb is not None
                     and hh.banded_nb[l] is not None)
        else _pick_format(m, pars)
        for l, m in enumerate(hh.a)
    ]
    # shard_map ring packing (pars.dist_devices = D > 1): every level pad
    # must split into D equal shards of whole format granules
    D = max(pars.dist_devices, 1)
    pads = [
        _round_up(
            max(m.n_rows, 1),
            D * (1024 if fmts[l] == "well"
                 else 128 if fmts[l] in ("dense", "banded") else 8),
        )
        for l, m in enumerate(hh.a)
    ]
    # a WEll level's R output is the child's vector: 1024-align the child
    # pad too so R can also pack as WEll (dense/banded accept any
    # 128-multiple pad; the extra <=1023 rows are masked like any padding)
    for l in range(1, nl):
        if fmts[l - 1] == "well" and fmts[l] != "dia":
            pads[l] = _round_up(pads[l], D * 1024)
    pad0 = pads[0]
    for l in range(1, E + 1):
        pads[l] = pad0

    timers = os.environ.get("AMG_SETUP_TIMERS", "0") == "1"
    levels = []
    for l in range(nl):
        t_l = time.perf_counter()
        if E >= 1 and l <= E:
            pad_next = pads[l + 1] if l < nl - 1 else None
            levels.append(
                _embedded_level(hh, l, E, emb, pad0, pad_next, dtype, pars,
                                boundary=boundary)
            )
        else:
            p = hh.p[l] if l < nl - 1 else None
            r = hh.r[l] if l < nl - 1 else None
            cf = hh.cfmark[l] if l < len(hh.cfmark) else None
            pad_coarse = pads[l + 1] if l < nl - 1 else None
            gs_key = hh.gs_key[l] if hh.gs_key is not None else None
            levels.append(
                _level_from_csr(hh.a[l], p, r, cf, pads[l], pad_coarse, dtype,
                                pars, gs_key=gs_key, is_coarse=l >= 1,
                                banded_nb=(hh.banded_nb[l]
                                           if hh.banded_nb is not None
                                           else None))
            )
        if timers:
            for v in jax.tree_util.tree_leaves(levels[-1]):
                if hasattr(v, "block_until_ready"):
                    v.block_until_ready()
            import sys

            print(f"  pack level {l}: {time.perf_counter() - t_l:.2f}s",
                  file=sys.stderr, flush=True)

    # dense inverse of the coarsest operator, on the host (LAPACK).  The
    # result is stored (and applied) in the solve dtype, so invert in that
    # dtype directly: at a few-thousand-row coarsest level the f32 inverse
    # is ~2x faster than inverting in f64 and discarding the extra bits.
    ac = hh.a[-1]
    pad_c = pads[-1]
    inv_dtype = np.dtype(dtype) if np.dtype(dtype) in (
        np.dtype(np.float32), np.dtype(np.float64)) else np.float32
    t_inv = time.perf_counter()
    try:
        inv = np.linalg.inv(ac.to_dense(inv_dtype))
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(ac.to_dense(inv_dtype))
    if not np.all(np.isfinite(inv)):
        inv = np.linalg.pinv(ac.to_dense(inv_dtype))
    full = np.zeros((pad_c, pad_c), dtype=inv_dtype)
    full[: ac.n_rows, : ac.n_cols] = inv
    coarse_inv = jnp.asarray(full.astype(np.dtype(dtype)))
    if timers:
        coarse_inv.block_until_ready()
        import sys

        print(f"  pack coarse inverse: {time.perf_counter() - t_inv:.2f}s",
              file=sys.stderr, flush=True)
    return Hierarchy(levels=tuple(levels), coarse_inv=coarse_inv)


def setup(a: CSR, pars: AMGParams, log=print,
          hh: Optional[HostHierarchy] = None) -> tuple[Hierarchy, HostHierarchy]:
    """Full setup: host hierarchy + device pack, with reference-format
    complexity table and timing print.

    Pass a pre-built (e.g. checkpoint-restored) ``hh`` to skip the host
    coarsening and go straight to the device pack.
    """
    t = time.perf_counter()
    if hh is None:
        hh = setup_host(a, pars, log=log)
    t_host = time.perf_counter() - t
    t = time.perf_counter()
    plan = embedding_plan(hh, pars)
    t_plan = time.perf_counter() - t
    t = time.perf_counter()
    # hh.perms set => reorder_for_gs already ran on this hierarchy (e.g. a
    # checkpoint-restored one, saved post-reorder): the matrices are
    # already permuted and banded_nb is recorded, so skip the expensive
    # re-coloring/RCM pass
    if pars.reorder_gs and hh.perms is None:
        reorder_for_gs(hh, pars, skip_levels=plan[0])
    elif pars.reorder_gs and hh.perms is not None and hh.perms[0] is None \
            and plan[0] == 0:
        # hierarchy restored from a checkpoint written before level-0
        # reordering existed: the coarse perms are baked in, but a WEll
        # level 0 still needs its RCM pass (slot windows blow up without)
        reorder_l0_for_well(hh, pars)
    t_reorder = time.perf_counter() - t
    t = time.perf_counter()
    mg = to_device(hh, pars, plan=plan)
    t_pack = time.perf_counter() - t
    if os.environ.get("AMG_SETUP_TIMERS", "0") == "1":
        log(f"setup phases: host {t_host:.2f}s, plan {t_plan:.2f}s, "
            f"reorder {t_reorder:.2f}s, pack {t_pack:.2f}s")
    if pars.verbose:
        log(complexity_print(hh))
        log(f"AMG setup time: {hh.setup_seconds:g} s")
    return mg, hh
