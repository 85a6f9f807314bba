"""amg_tpu — an accelerator algebraic multigrid framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
CPU/GPU AMG solver (txthpc/amg): classical Ruge-Stueben setup, V/W-cycle
solve with multicolor smoothers, Krylov solvers, MatrixMarket I/O, and
multi-chip row-sharded operation over a ``jax.sharding.Mesh``.

Quick start::

    import amg_tpu as amg

    a = amg.poisson2d(128)
    solver = amg.AMGSolver(a, amg.AMGParams(tol=1e-8))
    x, info = solver.solve(b=np.ones(a.n_rows))
"""

# f64 must be enabled before any jax array is created; the solver defaults
# to float64 like the reference (all-double, amg/SSS_main.h:95-131).
import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .params import (  # noqa: E402
    AMGParams,
    SolveInfo,
    SmootherType,
    InterpType,
    CoarsenType,
    StopType,
    CoarsestSolver,
)
from .sparse import CSR, Ell, Dia  # noqa: E402
from .io.matrix_market import read_mtx, write_mtx  # noqa: E402
from .io.generators import poisson2d, poisson3d, random_spd, fem2d  # noqa: E402
from .hierarchy import setup, setup_host, Hierarchy, Level  # noqa: E402
from .solve.driver import AMGSolver, solver_amg  # noqa: E402
from .solve.krylov import cg, gmres  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AMGParams",
    "SolveInfo",
    "SmootherType",
    "InterpType",
    "CoarsenType",
    "StopType",
    "CoarsestSolver",
    "CSR",
    "Ell",
    "Dia",
    "read_mtx",
    "write_mtx",
    "poisson2d",
    "poisson3d",
    "random_spd",
    "fem2d",
    "setup",
    "setup_host",
    "Hierarchy",
    "Level",
    "AMGSolver",
    "solver_amg",
    "cg",
    "gmres",
]
