"""Solver parameters, enums and error codes.

Mirrors the behavioral surface of the reference's ``SSS_AMG_PARS`` struct and
its enums (reference: ``amg/SSS_main.h:87-194``) and the CLI defaults set in
``SSS_amg_pars_init`` (reference: ``amg/SSS_main.c:25-64``).  The design is a
frozen dataclass (hashable, usable as a jit static argument) instead of a
mutable C struct.
"""

from __future__ import annotations

import dataclasses
import enum


class SmootherType(enum.IntEnum):
    """Smoother selection (reference enum ``SSS_SM_TYPE``, amg/SSS_main.h:133-145).

    The reference declares nine smoothers but only GS is live in its dispatch
    (amg/Solve/SSS_smooth.c:138-220).  Here every listed smoother is
    implemented, plus additions (L1-Jacobi, Chebyshev).
    """

    JACOBI = 1
    GS = 2
    SGS = 3
    CG = 4          # Krylov smoothing: fixed-step Jacobi-PCG sweeps
                    # (nonlinear — pair with a flexible outer wrap)
    SOR = 5
    SSOR = 6
    GSOR = 7
    SGSOR = 8
    POLY = 9
    L1DIAG = 10
    # extensions (not in reference enum):
    WJACOBI = 20    # weighted Jacobi (relax factor)
    CHEBYSHEV = 21  # polynomial smoother tuned by spectral bounds


class InterpType(enum.IntEnum):
    """Interpolation scheme (reference ``interp_type``, amg/SSS_main.h:147-152)."""

    DIR = 1   # direct interpolation
    STD = 2   # standard (distance-2) interpolation


class CoarsenType(enum.IntEnum):
    """Coarsening scheme (reference ``SSS_COARSEN_TYPE``, amg/SSS_main.h:163-168).

    RS / RSP follow the reference; PMIS is the parallel-friendly addition
    used at scale (the reference's greedy RS queue is inherently serial).
    """

    RS = 1
    RSP = 2
    PMIS = 3
    SA = 4    # smoothed aggregation (addition): ~3x faster
              # coarsening per level with leaner Galerkin stencils


class StopType(enum.IntEnum):
    """Krylov stopping criterion (reference ``SSS_STOP_TYPE``, amg/SSS_main.h:87-93)."""

    REL_RES = 1        # ||r|| / ||b||
    REL_PRECRES = 2    # ||r||_B / ||b||_B
    MOD_REL_RES = 3    # ||r|| / ||x||


class CoarsestSolver(enum.IntEnum):
    """Coarsest-level solver choice.

    The reference hard-wires CG with a GMRES fallback
    (amg/Solve/SSS_cycle.cu:819-846).  On an accelerator the idiomatic choice
    for a tiny coarsest system is a dense inverse applied as one matvec, so
    that is the default; KRYLOV reproduces reference behavior.
    """

    DENSE = 1     # densify + host LU inverse (default)
    KRYLOV = 2    # CG -> GMRES fallback (reference behavior)


class ErrorCode(enum.IntEnum):
    """Error codes (reference amg/SSS_main.h:37-63)."""

    SUCCESS = 0
    ERROR_OPEN_FILE = -10
    ERROR_WRONG_FILE = -11
    ERROR_INPUT_PAR = -13
    ERROR_MAT_SIZE = -23
    ERROR_MISC = -100
    ERROR_SOLVER_TYPE = -201
    ERROR_SOLVER_PRECTYPE = -202
    ERROR_SOLVER_STAG = -203
    ERROR_SOLVER_SOLSTAG = -204
    ERROR_SOLVER_TOLSMALL = -205
    ERROR_SOLVER_MAXIT = -208
    ERROR_SOLVER_EXIT = -209
    ERROR_SOLVER_MISC = -210
    ERROR_AMG_INTERP_TYPE = -301
    ERROR_AMG_SMOOTHER_TYPE = -302
    ERROR_AMG_COARSE_TYPE = -303
    ERROR_AMG_COARSEING = -304
    ERROR_AMG_SETUP = -305
    ERROR_UNKNOWN = -99


# Reference constants (amg/SSS_main.h:16-32)
MAX_AMG_LVL = 30
MIN_CDOF = 10
SMALLFLOAT = 1e-20
BIGFLOAT = 1e20

# C/F marker values (amg/SSS_main.h:24-32)
FGPT = 0   # fine grid point
CGPT = 1   # coarse grid point
ISPT = 2   # isolated point
UNPT = -1  # undecided point

MAX_STAG = 20
MAX_RESTART = 30


@dataclasses.dataclass(frozen=True)
class AMGParams:
    """All solver parameters.

    Defaults replicate the reference CLI defaults
    (``SSS_amg_pars_init``, amg/SSS_main.c:25-64).
    """

    smoother: SmootherType = SmootherType.GS
    max_it: int = 100
    tol: float = 1e-6
    ctol: float = 1e-7            # coarsest-level tolerance
    max_levels: int = 30
    coarse_dof: int = MIN_CDOF
    cycle_type: int = 1           # 1 = V-cycle, 2 = W-cycle
    cf_order: int = 1             # 0: natural order, 1: C/F order
    pre_iter: int = 2
    post_iter: int = 2
    relax: float = 1.0            # SOR relaxation / weighted-Jacobi weight
    poly_deg: int = 3
    cs_type: CoarsenType = CoarsenType.RS
    interp_type: InterpType = InterpType.DIR
    max_row_sum: float = 0.9
    strong_threshold: float = 0.3
    trunc_threshold: float = 0.2

    # --- extensions (no reference equivalent) ---
    coarsest_solver: CoarsestSolver = CoarsestSolver.DENSE
    stop_type: StopType = StopType.REL_RES
    dtype: str = "float64"        # compute dtype for the solve phase
    setup_dtype: str = "float64"  # host setup always runs f64
    verbose: int = 1
    # Device-format selection
    max_diags: int = 96           # use DIA when distinct offsets <= this
    max_dia_fill: float = 6.0     # ... and nd*n/nnz <= this
    # Permute coarse ELL levels color-contiguously so GS sweeps are static
    # row-range slices (one SpMV's work) instead of padded gathers
    reorder_gs: bool = True
    # Densify a level (dense matvec, zero gathers) when its dense footprint
    # n_rows*n_cols*dtype_size fits this budget (deep levels are small but
    # nearly dense, so a sparse format would mostly stream indices)
    dense_level_bytes: float = 2e9
    # Embed coarse levels in the fine-grid index space: coarse unknowns keep
    # their level-0 positions, so A_l / P_l / R_l become diagonal-offset
    # stencils (Dia) over the fine grid — ZERO gathers in the whole cycle.
    # Vectors at embedded
    # levels are fine-grid length; an embedded level costs nd_l * n0
    # streamed bytes per operator pass.  Levels stop embedding when the
    # stencil grows past `embed_max_diags` or the budget; unstructured
    # problems fall back to compact formats automatically.
    # -1 = auto = 0: the compact gather formats are the default on every
    # backend (a GS sweep over an embedded wide-DIA level lowers to
    # thousands of fused slices and is far slower to compile).  Explicit
    # values force embedding (the emulated-mesh shard_map tests do this).
    embed_levels: int = -1
    embed_max_diags: int = 320
    embed_max_bytes: float = 6e9
    # Boundary between the embedded and compact worlds: "embedded" applies
    # fine-grid-embedded P_E/R_E (pure streaming, but nd * n0 bytes each),
    # "compact" compacts the residual first (one small gather) and applies
    # compact Ell P/R on short vectors (only A_E needs the embedded array —
    # how deep embedding stays affordable at 10M+ rows).  "auto" picks
    # embedded when it fits the byte budget, else compact.
    embed_boundary: str = "auto"
    # Smoother override for levels >= 1 (None = pars.smoother everywhere).
    # Masked Gauss-Seidel on an embedded level costs n_colors full operator
    # passes per sweep; Chebyshev costs poly_deg passes regardless.
    coarse_smoother: "SmootherType | None" = None
    # Per-level polynomial-smoother degree schedule (applies to POLY /
    # Chebyshev smoothing): level l uses poly_deg_schedule[min(l, len-1)].
    # None = pars.poly_deg everywhere.  Lighter smoothing at depth trims
    # operator passes on the mid levels where the cycle spends most of its
    # memory traffic (a degree-d application streams d operator passes).
    poly_deg_schedule: "tuple[int, ...] | None" = None
    # Storage dtype for coarse-level (>= 1) operator values ("same" or e.g.
    # "bfloat16"): coarse corrections are a preconditioner, so half-precision
    # operator storage halves the dominant memory traffic with little
    # convergence impact (outer accuracy comes from defect correction).
    coarse_op_dtype: str = "same"
    # Storage dtype for the P/R transfer-operator VALUES on WEll levels
    # ("same" = solve dtype).  bf16 halves the value planes (wide coarse
    # rows are the WEll worst case); interpolation weights tolerate bf16
    # far better than A itself, and the FCG wrap + f64 outer absorb the
    # rest.
    transfer_op_dtype: str = "same"
    # Mixed-precision defect correction: run the V-cycles in `dtype`
    # (f32/bf16 — half the bytes of f64) but iterate the correction
    # against an f64 level-0 residual, reaching f64-grade tolerances
    # (e.g. 1e-8) at low-precision speed.  Mixed-precision alternative to
    # the reference's all-double arithmetic (SURVEY.md section 7 hard
    # part 4).
    refine: bool = False
    refine_inner_cycles: int = 4
    # Krylov acceleration: "none" = stand-alone cycling (reference
    # behavior), "cg" = flexible CG with one AMG cycle as the
    # preconditioner (standard production mode; typically 30-50% fewer
    # cycles at tight tolerances).  Combines with mixed precision: the
    # FCG outer iteration runs in f64 against the f64 operator while the
    # preconditioner cycle runs in `dtype`.
    accel: str = "none"
    # Block-banded format for gather-bound coarse levels: RCM-reorder the
    # level and store dense 128x128 blocks along the block band when that
    # fits `banded_level_bytes` — static shifted slices + batched block
    # matvec instead of gathers.  "auto" enables it on a single device;
    # "on"/"off" force.
    use_banded: str = "auto"
    # sized so a 10M-row Poisson's level-3 RCM band (~3.05 GB) qualifies
    banded_level_bytes: float = 3.5e9
    # When the RCM band slightly exceeds the byte budget, clip the band at
    # the largest nb that fits and lump the out-of-band entries into the
    # diagonal — IF they are at most this fraction of the level's nnz
    # (geometric cousin of coarse_sparsify; row sums preserved).
    banded_clip_frac: float = 0.02
    # Windowed-gather ELL (WEll) for large UNSTRUCTURED levels that would
    # otherwise fall to gather-ELL.  Levels picked for WEll are RCM/barycentrically reordered so each slot's 1024-wide
    # x window stays local.  "auto" enables it on a single device for
    # levels >= well_min_rows; "on"/"off" force.
    use_well: str = "auto"
    well_min_rows: int = 65536
    # Pack the hierarchy for a D-device shard_map ring solve: level pads
    # round up to D-divisible format granules, WEll/BandedBlocks stay
    # enabled under "auto" despite jax.device_count() > 1 (their ring
    # variants in parallel/halo.py are the consumers), and WEll packs
    # precompute ring halo plans.  0 = single-device layout (default).
    dist_devices: int = 0
    # Non-Galerkin coarse-operator sparsification (Falgout/Schroder-style):
    # on levels >= sparsify_from_level drop entries with
    # |a_ij| < threshold * sqrt(|a_ii a_jj|) and lump the dropped mass
    # into the diagonal (row sums preserved).  RS-AMG Galerkin stencils
    # grow to hundreds of nnz/row at depth and every one of those is a
    # gather, so sparsification directly buys per-cycle time.  0 = off
    # (exact Galerkin parity with the reference).
    coarse_sparsify: float = 0.0
    sparsify_from_level: int = 3
    # Stop coarsening once a level has at most this many rows (0 = off,
    # i.e. reference behavior: coarsen down to ~coarse_dof).  Unlike
    # coarse_dof — whose "col < coarse_dof" check DISCARDS the offending
    # coarse level (amg/Setup/SSS_SETUP.cu:92-98) — this keeps the level
    # and makes it the coarsest.  Used to collapse the deep dense tail
    # into one dense inverse apply: the sub-10k levels cost more in per-op
    # dispatch overhead than their arithmetic.
    coarse_stop_rows: int = 0
    # Multi-device settings
    coarse_replicate_nnz: int = 65536  # replicate levels below this nnz/chip

    def replace(self, **kw) -> "AMGParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SolveInfo:
    """Return info (reference ``SSS_RTN``: ares, rres, nits)."""

    ares: float = 0.0
    rres: float = 0.0
    nits: int = 0
    residuals: list = dataclasses.field(default_factory=list)
    setup_seconds: float = 0.0
    solve_seconds: float = 0.0
