"""Benchmark harness.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Headline metric: sustained SpMV throughput (nnz/s) of the level-0 operator
during a full V-cycle solve of a 3D 7-point Poisson problem to 1e-8 relative
residual — i.e. end-to-end solve speed normalized by matrix size, the
BASELINE.json metric ("SpMV + V-cycle GFLOP/s and nnz/s per chip;
iterations to 1e-8 residual").  It runs on a GPU only and exits non-zero
when JAX finds none.

Environment knobs:
    AMG_BENCH_N      rows per side of the 3D grid  (default 100 -> 1M rows)
    AMG_BENCH_DTYPE  float32 | float64             (default float32)
    AMG_BENCH_SMOOTHER  GS | CHEBYSHEV | L1DIAG ... (default GS)
Secondary measurements go to stderr.
"""

import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
# generated-matrix and host-hierarchy caches (gitignored)
_CACHE = os.path.join(_HERE, ".bench_cache")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_params(n_side: int, dtype: str, smoother_name: str = "GS",
                 matrix_spec: str = ""):
    """The benchmark's solver parameters for a ``poisson3d:n_side`` grid
    (``matrix_spec`` empty) or a CLI matrix spec, with the ``AMG_BENCH_*``
    overrides read from the environment."""
    import amg_tpu as amg
    from amg_tpu.params import SmootherType

    # BASELINE.md target: iterations to 1e-8 relative residual.  The cycles
    # run in `dtype` (f32 by default); mixed-precision defect correction
    # (f64 outer residual) carries the solve past the f32 precision floor.
    tol = float(os.environ.get("AMG_BENCH_TOL", "1e-8"))
    refine = dtype != "float64" and os.environ.get(
        "AMG_BENCH_REFINE", "1") == "1"
    # Chebyshev on coarse levels lets the fine-grid embedding reach deeper
    # (masked GS costs n_colors operator passes per sweep on an embedded
    # level); level 0 keeps the configured smoother.
    coarse_sm = os.environ.get("AMG_BENCH_COARSE_SMOOTHER", "CHEBYSHEV")
    # Per-class defaults (measured, fem2d 1M, FCG f64 outer): on
    # unstructured matrices bf16 coarse operators cost 34->48 its and
    # sparsify 0.005 costs 16->34 its — their byte savings nowhere near
    # pay for the lost convergence — while on structured grids both are
    # near-free and sparsify is what keeps 10M-row setups in HBM.
    coarse_od = os.environ.get(
        "AMG_BENCH_COARSE_OP_DTYPE",
        "float32" if matrix_spec else "bfloat16")
    # Default acceleration by scale.  Small/medium grids: stand-alone
    # cycling + defect correction.  Large grids: FCG — operator sparsification kicks in there, and the
    # sparsified V-cycle is a good preconditioner but NOT a contraction
    # (stand-alone cycling diverged at 10M rows); the Krylov wrap is what
    # makes it robust.
    # Unstructured/file matrices also default to FCG: their sparsified
    # cycles are good preconditioners but not reliable contractions
    # (fem2d at 1M rows diverged under stand-alone cycling).
    accel = os.environ.get("AMG_BENCH_ACCEL",
                           "cg" if (n_side >= 128 or matrix_spec)
                           else "none")
    embed_bytes = float(os.environ.get("AMG_BENCH_EMBED_BYTES", "6e9"))
    sparsify = float(os.environ.get(
        "AMG_BENCH_SPARSIFY", "0" if matrix_spec else "0.005"))
    sparsify_from = int(os.environ.get("AMG_BENCH_SPARSIFY_FROM", "2"))
    banded_bytes = float(os.environ.get("AMG_BENCH_BANDED_BYTES", "3.5e9"))
    # collapse the deep dense tail into one dense inverse apply: stop
    # coarsening once a level is <= this many rows and solve it directly
    # (the sub-10k dense levels cost more in per-op dispatch overhead
    # than their arithmetic; one n_c^2 matvec replaces 2-3 levels of
    # smoothing + transfers).  0 restores reference-style deep coarsening.
    # 3500 keeps the host LAPACK inverse of the coarsest level small.
    coarse_stop = int(os.environ.get("AMG_BENCH_COARSE_STOP", "3500"))
    # e.g. "3,3,2,1": per-level Chebyshev/POLY degree (lighter at depth)
    sched_env = os.environ.get("AMG_BENCH_POLY_SCHED", "")
    poly_sched = (tuple(int(t) for t in sched_env.split(","))
                  if sched_env else None)
    from amg_tpu.params import InterpType, CoarsenType

    interp = InterpType[os.environ.get("AMG_BENCH_INTERP", "DIR")]
    cs_type = CoarsenType[os.environ.get("AMG_BENCH_CS", "RS")]
    transfer_od = os.environ.get("AMG_BENCH_TRANSFER_DTYPE", "same")
    pars = amg.AMGParams(
        interp_type=interp,
        cs_type=cs_type,
        transfer_op_dtype=transfer_od,
        cycle_type=int(os.environ.get("AMG_BENCH_CYCLE", "1")),
        poly_deg_schedule=poly_sched,
        coarse_stop_rows=coarse_stop,
        embed_max_bytes=embed_bytes,
        coarse_sparsify=sparsify,
        sparsify_from_level=sparsify_from,
        banded_level_bytes=banded_bytes,
        tol=tol,
        dtype=dtype,
        smoother=SmootherType[smoother_name],
        coarse_smoother=(SmootherType[coarse_sm] if coarse_sm else None),
        coarse_op_dtype=coarse_od,
        verbose=0,
        max_it=60,
        refine=refine,
        accel=accel,
    )
    return pars

def main():
    n_side = int(os.environ.get("AMG_BENCH_N", "100"))
    dtype = os.environ.get("AMG_BENCH_DTYPE", "float32")
    smoother_name = os.environ.get("AMG_BENCH_SMOOTHER", "GS")

    from amg_tpu.device import card_line, require_gpu, hbm_peak

    card = card_line()
    import jax

    from amg_tpu.compile_cache import enable as _enable_cache
    _enable_cache()
    device = require_gpu()
    hbm_bps = hbm_peak(device["kind"])

    import amg_tpu as amg
    from amg_tpu.ops.spmv import spmv

    matrix_spec = os.environ.get("AMG_BENCH_MATRIX", "")
    log(f"device: {device}, card: {card}, "
        f"{matrix_spec or f'grid {n_side}^3'}, dtype {dtype}")

    t0 = time.perf_counter()
    if matrix_spec:
        # any CLI matrix spec (fem2d:N[:graded], poisson2d:N, file.mtx...)
        # generator specs are deterministic, so cache the assembled CSR
        # (a 10M-row Delaunay FEM assembly takes minutes)
        from amg_tpu.cli import load_matrix
        from amg_tpu.sparse import CSR

        a = None
        os.makedirs(_CACHE, exist_ok=True)
        mpath = os.path.join(
            _CACHE, "mat_" + matrix_spec.replace(":", "-").replace("/", "_")
            + ".npz")
        cacheable = (":" in matrix_spec
                     and os.environ.get("AMG_BENCH_MATRIX_CACHE", "1")
                     == "1")
        if cacheable and os.path.exists(mpath):
            try:
                z = np.load(mpath)
                a = CSR(z["indptr"], z["indices"], z["data"],
                        tuple(int(v) for v in z["shape"]))
                log(f"matrix cache hit ({mpath})")
            except Exception as exc:
                log(f"matrix cache unreadable ({exc}); regenerating")
        if a is None:
            a = load_matrix(matrix_spec)
            if cacheable:
                try:
                    np.savez(mpath, indptr=a.indptr, indices=a.indices,
                             data=a.data, shape=np.asarray(a.shape))
                except Exception as exc:
                    log(f"matrix cache save failed: {exc}")
    else:
        a = amg.poisson3d(n_side)
    log(f"assembled A: n={a.n_rows}, nnz={a.nnz} "
        f"({time.perf_counter()-t0:.2f}s)")

    pars = bench_params(n_side, dtype, smoother_name, matrix_spec)

    # host-hierarchy cache: at 10M rows host coarsening takes minutes; the
    # hierarchy depends only on the matrix + setup params, so reuse it
    # across bench invocations (AMG_BENCH_HIER_CACHE=0 disables)
    hh = None
    cache_path = None
    if os.environ.get("AMG_BENCH_HIER_CACHE", "1") == "1":
        from amg_tpu.io.checkpoint import load_hierarchy, save_hierarchy

        mk = matrix_spec.replace(":", "-").replace("/", "_") or f"n{n_side}"
        key = (f"{mk}_st{pars.strong_threshold}_tt{pars.trunc_threshold}"
               f"_cs{int(pars.cs_type)}_it{int(pars.interp_type)}"
               + (f"_sp{pars.coarse_sparsify}" if pars.coarse_sparsify
                  else "")
               + (f"_sf{pars.sparsify_from_level}"
                  if pars.coarse_sparsify
                  and pars.sparsify_from_level != 3 else "")
               + (f"_cd{pars.coarse_stop_rows}"
                  if pars.coarse_stop_rows else ""))
        os.makedirs(_CACHE, exist_ok=True)
        cache_path = os.path.join(_CACHE, f"hier_{key}.npz")
        if os.path.exists(cache_path):
            t0 = time.perf_counter()
            try:
                hh = load_hierarchy(cache_path)
                log(f"hierarchy cache hit ({time.perf_counter()-t0:.1f}s)")
            except Exception as exc:
                log(f"hierarchy cache unreadable ({exc}); rebuilding")
                hh = None

    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, pars, log=log, host_hierarchy=hh)
    setup_s = time.perf_counter() - t0
    if cache_path and hh is None:
        from amg_tpu.io.checkpoint import save_hierarchy

        t0 = time.perf_counter()
        try:
            save_hierarchy(cache_path, solver.host_hierarchy, compress=False)
            log(f"hierarchy cached -> {cache_path} "
                f"({time.perf_counter()-t0:.1f}s)")
        except Exception as exc:
            log(f"hierarchy cache save failed: {exc}")
    log(f"setup: {setup_s:.2f}s ({'warm-host' if hh is not None else 'cold'}), "
        f"levels={[m.n_rows for m in solver.host_hierarchy.a]}")
    log(f"formats: "
        f"{[type(l.a).__name__ for l in solver.mg.levels]}")

    extra = {
        "device": device,
        "card": card,
        "setup_seconds": float(f"{setup_s:.4g}"),
        "setup_cold": hh is None,
    }

    b = np.ones(a.n_rows)

    # -- SpMV microbenchmark: per-level streaming rates -----------------
    # The timed chain rotates through enough DISTINCT operator copies that
    # their total size dwarfs the 50 MB L2, so every apply re-streams the
    # operator from device memory.  Reported GB/s is
    #   (operator bytes + x read + y write) / measured-time
    # and %SoL is that against the card's published memory bandwidth
    # (amg_tpu.device.HBM_PEAK_BYTES_PER_S).  The chain is sized so the
    # measured window is >= ~0.5 s.
    if os.environ.get("AMG_BENCH_SPMV", "1") != "1":
        log("spmv microbenchmark skipped (AMG_BENCH_SPMV=0)")
        return _finish(solver, a, b, pars, extra, log)
    hbm_gbps = hbm_bps / 1e9
    only = os.environ.get("AMG_BENCH_SPMV_LEVELS")  # e.g. "0,2"
    lv_sel = None if not only else {int(t) for t in only.split(",")}
    for li, lvl in enumerate(solver.mg.levels):
        if lv_sel is not None and li not in lv_sel:
            continue
        try:
            _level_spmv_bench(li, lvl, spmv, log, hbm_gbps)
        except jax.errors.JaxRuntimeError as exc:
            # near the memory limit the rotating copies / chain buffers may
            # not fit next to the resident hierarchy — skip the level
            # rather than lose the solve measurement
            log(f"spmv L{li} microbench skipped "
                f"({type(exc).__name__}: {str(exc)[:90]})")

    _finish(solver, a, b, pars, extra, log)


def _finish(solver, a, b, pars, extra, log):
    """Timed solve, then the warm re-setup measurement (with the first
    device hierarchy freed first — at 10M rows two resident hierarchies
    may not fit), then the single JSON line."""
    import json as _json
    import amg_tpu as amg

    result = _solve_bench(solver, a, b, log, extra=extra)
    # warm re-setup: host hierarchy in memory, device re-pack only — the
    # "second solve on this machine" cost (record cold AND warm setup so
    # the trend is readable)
    if os.environ.get("AMG_BENCH_WARM_SETUP", "1") == "1":
        hh_mem = solver.host_hierarchy
        # drop the device hierarchy before packing again (mutate the
        # object: the caller's frame still holds a reference, so `del`
        # alone frees nothing — two resident 10M hierarchies may not fit)
        for attr in ("mg", "a0_hi", "_hi_vals", "host_hierarchy"):
            if hasattr(solver, attr):
                setattr(solver, attr, None)
        del solver
        import jax as _jax

        try:
            t0 = time.perf_counter()
            warm = amg.AMGSolver(a, pars, log=lambda *x: None,
                                 host_hierarchy=hh_mem)
            warm_s = time.perf_counter() - t0
            del warm
            result["setup_warm_seconds"] = float(f"{warm_s:.4g}")
            log(f"warm re-setup (host hierarchy in memory): {warm_s:.2f}s")
        except _jax.errors.JaxRuntimeError as exc:
            log(f"warm re-setup skipped ({type(exc).__name__}: "
                f"{str(exc)[:120]})")
    print(_json.dumps(result), flush=True)


def _op_traffic_bytes(op, pad, x_itemsize):
    """Minimum memory traffic of one y = A @ x: every operator array read
    once, x read once, y written once."""
    import jax

    ob = sum(v.size * v.dtype.itemsize
             for v in jax.tree_util.tree_leaves(op) if hasattr(v, "dtype"))
    return ob + 2 * pad * x_itemsize


def _level_spmv_bench(li, lvl, spmv, log, hbm_gbps):
    import math
    import jax
    import jax.numpy as jnp

    op = lvl.a
    pad = op.padded_rows
    name = type(op).__name__
    xdt = jnp.dtype("float32") if any(
        v.dtype == jnp.bfloat16 for v in jax.tree_util.tree_leaves(op)
        if hasattr(v, "dtype")) else None
    x = jnp.ones(pad, dtype=xdt or _vals_dtype(op))
    tb = _op_traffic_bytes(op, pad, x.dtype.itemsize)
    if tb < 8e6:
        log(f"spmv L{li} [{name}] {tb/1e6:6.1f} MB/apply: "
            "latency-bound at this size, not measured")
        return
    # distinct copies totaling >= ~10x the L2 so values cannot stay
    # resident across chained applies
    ncopy = max(1, min(24, math.ceil(512e6 / tb)))
    ops = [op] + [
        jax.tree_util.tree_map(
            lambda v: jnp.array(v, copy=True) if hasattr(v, "dtype") else v,
            op)
        for _ in range(ncopy - 1)
    ]
    # normalize so the chained iterates neither overflow nor denormal
    # (one jitted program: eager ops each compile separately)
    c = 1.0 / max(float(jax.jit(
        lambda op, x: jnp.max(jnp.abs(spmv(op, x))))(op, x)), 1e-30)
    chain_len = 192
    sol_s = chain_len * tb / (hbm_gbps * 1e9)
    k_disp = max(1, min(400, math.ceil(0.5 / sol_s)))

    def _chain(ops, x):
        for i in range(chain_len):
            x = spmv(ops[i % len(ops)], x) * c
        return x

    cj = jax.jit(_chain)

    def _run(x):
        for _ in range(k_disp):
            x = cj(ops, x)
        return x.block_until_ready()

    _run(x)  # compile + warm
    t0 = time.perf_counter()
    _run(x)
    t = time.perf_counter() - t0
    per = max(t, 1e-9) / (chain_len * k_disp)
    gbs = tb / per / 1e9
    log(f"spmv L{li} [{name}] {tb/1e6:6.1f} MB/apply: {per*1e3:7.3f} ms, "
        f"{gbs:6.1f} GB/s = {100*gbs/hbm_gbps:5.1f}% of HBM SoL "
        f"({ncopy} rotating copies, {chain_len * k_disp} applies)")


def _vals_dtype(op):
    import jax
    import jax.numpy as jnp

    for v in jax.tree_util.tree_leaves(op):
        if hasattr(v, "dtype") and v.dtype in (jnp.float32, jnp.float64,
                                               jnp.bfloat16):
            return v.dtype
    return jnp.float32


def _solve_bench(solver, a, b, log, extra=None):
    """Warmup + timed solve + host verification + headline JSON line.

    Host loop over the jitted cycle+residual step.  The timed solve takes
    the best of five runs: host-side jitter is additive noise on a short
    solve, so min — not mean — estimates the machine's capability."""
    import numpy as np

    xw, info_w = solver.solve(b)
    log(f"warmup solve: {info_w.nits} its, rres {info_w.rres:.2e}, "
        f"{info_w.solve_seconds:.2f}s (includes compile)")
    x_sol, info = solver.solve(b)
    for _ in range(4):
        x2, i2 = solver.solve(b)
        if i2.solve_seconds < info.solve_seconds:
            x_sol, info = x2, i2
    log(f"solve: {info.nits} its, rres {info.rres:.2e}, "
        f"{info.solve_seconds:.3f}s (best of 5)")

    # verify on host
    r = b - a.matvec(x_sol.astype(np.float64))
    true_rres = float(np.linalg.norm(r) / np.linalg.norm(b))
    log(f"true rres: {true_rres:.3e}")

    # headline: nnz processed per second of solve =
    #   (sum over levels of per-cycle A-applications * level nnz) * cycles / t
    # approximate with level-0 work which dominates: per cycle the level-0
    # operator is applied ~(groups*(pre+post) + 1) times
    solve_nnz_s = a.nnz * info.nits / info.solve_seconds

    result = {
        "metric": "poisson3d_vcycle_solve_nnz_per_s",
        "value": float(f"{solve_nnz_s:.4g}"),
        "unit": "nnz*cycles/s",
    }
    result["solve_seconds"] = float(f"{info.solve_seconds:.4g}")
    result["iterations"] = int(info.nits)
    result["true_rres"] = float(f"{true_rres:.3g}")
    if extra:
        result.update(extra)
    return result


if __name__ == "__main__":
    main()
