"""Weak-scaling benchmark: solve nnz/s per device count.

For each mesh size N (powers of two up to the available device count), a
3D Poisson problem with ~``AMG_DIST_ROWS_PER_DEV`` rows per device is
solved by :class:`~amg_tpu.parallel.DistAMGSolver`, and throughput
``nnz * cycles / solve_seconds`` plus weak-scaling efficiency vs N=1 is
reported (the BASELINE.json north star: >= 70% at 2+ hosts).

Run with ``JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8`` to exercise the SPMD
code path on an emulated mesh (throughput numbers on emulated CPU devices
are functional, not performance, results).

Prints one JSON line per mesh size.

Multi-host modes (VERDICT round-1 item 4):
  * ``python bench_dist.py --spawn K`` launches K OS processes on this
    machine, each with ``AMG_DIST_LOCAL_DEV`` emulated CPU devices, joined
    by ``jax.distributed`` — the emulated weak-scaling run across process
    boundaries.
  * On a real multi-host cluster, run one copy per host with
    ``AMG_COORDINATOR=host0:port AMG_NUM_PROCESSES=H AMG_PROCESS_ID=i``;
    :func:`amg_tpu.parallel.initialize` picks these up below.
"""

import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def spawn(nproc: int):
    """Launch ``nproc`` worker copies of this script joined via
    jax.distributed over localhost, stream rank 0's output."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    local_dev = os.environ.get("AMG_DIST_LOCAL_DEV", "4")
    procs = []
    for i in range(nproc):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={local_dev}",
            AMG_COORDINATOR=f"localhost:{port}",
            AMG_NUM_PROCESSES=str(nproc),
            AMG_PROCESS_ID=str(i),
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)],
            env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=None if i == 0 else subprocess.DEVNULL,
            stderr=None if i == 0 else subprocess.DEVNULL,
        ))
    try:
        rc = max(p.wait() for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    sys.exit(rc)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--spawn":
        spawn(int(sys.argv[2]))

    from amg_tpu.parallel import initialize

    multiproc = initialize()

    import jax

    from amg_tpu.compile_cache import enable as _enable_cache
    _enable_cache()

    import numpy as np
    import amg_tpu as amg
    from amg_tpu.parallel import DistAMGSolver, make_mesh
    from amg_tpu.params import SmootherType

    rows_per_dev = int(os.environ.get("AMG_DIST_ROWS_PER_DEV", "262144"))
    ndev_avail = min(
        jax.device_count(),
        int(os.environ.get("AMG_DIST_MAX_DEV", "1024")),
    )
    log(f"devices: {ndev_avail} x {jax.devices()[0].device_kind}")

    base_nnz_s = None
    if multiproc:
        # multi-process runs use the one full global mesh (a sub-mesh
        # would leave some processes without addressable shards); the
        # single-device baseline for the efficiency column comes from a
        # prior single-process run via AMG_DIST_BASE_NNZ_S
        log(f"multi-process: {jax.process_count()} processes x "
            f"{jax.local_device_count()} local devices")
        sizes = [ndev_avail]
        if "AMG_DIST_BASE_NNZ_S" in os.environ:
            base_nnz_s = float(os.environ["AMG_DIST_BASE_NNZ_S"])
    else:
        sizes = []
        n = int(os.environ.get("AMG_DIST_MIN_DEV", "1"))
        while n <= ndev_avail:
            sizes.append(n)
            n *= 2

    # AMG_DIST_SOLVER: spmd (default; hand-placed shard_map cycle, the
    # preferred multi-chip path) | gspmd (sharding-annotated solver) |
    # spmd-cg (shard_map FCG wrap — the robust 10M-row mode)
    which = os.environ.get("AMG_DIST_SOLVER", "spmd")
    # AMG_DIST_MATRIX=fem2d exercises the general sharded cycle
    # (row-sharded WEll levels with ring P/R transfers) instead of the
    # embedded-DIA cycle
    mat_kind = os.environ.get("AMG_DIST_MATRIX", "poisson3d")
    for ndev in sizes:
        if mat_kind == "fem2d":
            from amg_tpu.io.generators import fem2d

            a = fem2d(rows_per_dev * ndev, seed=7)
        else:
            n_side = max(int(round((rows_per_dev * ndev) ** (1.0 / 3.0))),
                         8)
            a = amg.poisson3d(n_side)
        pars = amg.AMGParams(
            tol=1e-8, dtype="float32", refine=True, verbose=0,
            coarse_smoother=SmootherType.CHEBYSHEV,
            coarse_op_dtype=("float32" if mat_kind == "fem2d"
                             else "bfloat16"),
            use_well="on" if mat_kind == "fem2d" else "auto",
            well_min_rows=1024 if mat_kind == "fem2d" else 65536,
            accel="cg" if (which == "spmd-cg" or mat_kind == "fem2d")
            else "none",
        )
        mesh = make_mesh(ndev)
        t0 = time.perf_counter()
        if which in ("spmd", "spmd-cg"):
            from amg_tpu.parallel.spmd_cycle import SpmdAMGSolver

            try:
                solver = SpmdAMGSolver(a, pars, mesh=mesh, log=log)
            except ValueError as exc:
                log(f"spmd unavailable at N={ndev} ({exc}); gspmd")
                solver = DistAMGSolver(a, pars, mesh=mesh, log=log)
        else:
            solver = DistAMGSolver(a, pars, mesh=mesh, log=log)
        setup_s = time.perf_counter() - t0
        b = np.ones(a.n_rows)
        solver.solve(b)  # warmup (compile)
        x, info = solver.solve(b)
        r = b - a.matvec(x.astype(np.float64))
        true_rres = float(np.linalg.norm(r) / np.linalg.norm(b))
        nnz_s = a.nnz * info.nits / max(info.solve_seconds, 1e-9)
        if base_nnz_s is None:
            base_nnz_s = nnz_s / ndev
        eff = nnz_s / (base_nnz_s * ndev)
        log(f"N={ndev}: n={a.n_rows} nnz={a.nnz} its={info.nits} "
            f"rres={true_rres:.2e} setup={setup_s:.1f}s "
            f"solve={info.solve_seconds:.3f}s")
        print(json.dumps({
            "metric": "weak_scaling_solve_nnz_cycles_per_s",
            "devices": ndev,
            "value": float(f"{nnz_s:.4g}"),
            "unit": "nnz*cycles/s",
            "efficiency_vs_1dev": float(f"{eff:.4g}"),
            "true_rres": float(f"{true_rres:.3g}"),
        }), flush=True)


if __name__ == "__main__":
    main()
