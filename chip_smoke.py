#!/usr/bin/env python3
"""Smoke run of the AMG solve on NVIDIA GPUs.

    python chip_smoke.py           # phases a-f on one card
    python chip_smoke.py --large   # phase a + a 9.9M-row poisson3d:215 solve
    python chip_smoke.py --four    # phase a + the 4-card solvers vs card 0

Phases of the default run:

a. device: JAX's first device must be a GPU (there is no CPU fallback);
   prints the card (nvidia-smi name and power limit), JAX version, the
   compile-cache directory and whether the native setup library loaded.
b. card-only tests: ``pytest -m gpu`` in a child process, before this
   process touches JAX, so that one process holds the card at a time.
c. format parity at real widths: each device format's ``spmv`` against
   the host f64 CSR product.
d. main path: ``AMGSolver`` with bench.py's parameters; every solve must
   reach a host-verified true relative residual below 1e-8.
e. reference parity: 1138_bus in f64 with the reference defaults matches
   the pinned CPU golden residual history.
f. kernel finding: the XLA Dia SpMV, residual and masked GS update, and
   the WEll and Ell SpMVs, timed against a device copy in the same run;
   the coarsest-level inverse on the host against ``jnp.linalg.inv``.

Every phase raises on failure; the script then exits non-zero.  The last
line of standard output, printed only when every phase passed, is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOL_F32 = 1e-5     # f32 formats, relative to max|Ax|
TOL_F64 = 1e-12    # f64 formats and the df64 split pack
TOL_SOLVE = 1e-8   # host-verified true relative residual
# 1138_bus residual history against the CPU golden: entries match to
# GOLDEN_RTOL, down to a floor of GOLDEN_FLOOR * r0 — f64 roundoff
# amplified by the operator's conditioning (eps64 * kappa(1138_bus) with
# kappa ~ 1e7 is ~2e-9).  The GPU sums in another order, and the last
# entries (1e-6 * r0) sit near that floor.
GOLDEN_RTOL = 1e-6
GOLDEN_FLOOR = 1e-9

CARD = "not read"


def say(*parts):
    print(*parts, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


@contextmanager
def phase(name: str):
    say(f"== phase {name}")
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        say(f"!! phase {name} FAILED after {time.perf_counter() - t0:.1f} s")
        raise
    say(f"-- phase {name} ok ({time.perf_counter() - t0:.1f} s)")


def rel_err(y, want) -> float:
    y = np.asarray(y, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(y - want)) / max(np.max(np.abs(want)),
                                                1e-300))


# ---------------------------------------------------------------------------
# a. device
# ---------------------------------------------------------------------------


def probe_device() -> dict:
    """Platform, kind and count of JAX's devices, read in a child process
    so this one stays off the card until phase b has run."""
    code = ("import json; from amg_tpu.device import describe; "
            "print(json.dumps(describe()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"device probe failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_a(expect_count: int | None = None) -> dict:
    global CARD
    import jax
    from amg_tpu.device import card_line
    from amg_tpu.compile_cache import cache_dir
    from amg_tpu.native import lib

    dev = probe_device()
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: no GPU — JAX's first device is "
                         f"{dev['platform']} ({dev['kind']}); this script "
                         "runs on an NVIDIA GPU only")
    CARD = card_line()
    say(f"  device_kind: {dev['kind']}   count: {dev['count']}")
    say(f"  jax {jax.__version__}   compile cache: {cache_dir()}")
    say(f"  native setup library loaded: {lib is not None}")
    say(f"  card (nvidia-smi name, power.limit): {CARD}")
    if expect_count is not None:
        check(dev["count"] >= expect_count,
              f"needs {expect_count} GPUs, JAX sees {dev['count']}")
    return dev


# ---------------------------------------------------------------------------
# b. card-only tests
# ---------------------------------------------------------------------------


def phase_b():
    env = dict(os.environ, AMG_TEST_PLATFORM="cuda")
    cmd = [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
           "-p", "no:cacheprovider", "--durations=0", "tests"]
    say("  " + " ".join(cmd[1:]))
    out = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=900)
    tail = out.stdout.strip().splitlines()[-30:]
    for line in tail:
        say("  | " + line)
    check(out.returncode == 0, f"pytest -m gpu exited {out.returncode}:\n"
          + out.stderr[-2000:])
    check(" passed" in tail[-1] and "skipped" not in tail[-1],
          "every gpu test must run and pass on the card")


# ---------------------------------------------------------------------------
# c. format parity at real widths
# ---------------------------------------------------------------------------


def rcm(a):
    """Reverse Cuthill-McKee ordering of a host CSR (windows hug the
    diagonal, as the WEll levels of a hierarchy are ordered)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    perm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                      dtype=np.int64)
    return a.permute(perm)


def format_parity(name, op, a, x_dtype, tol, precision):
    """spmv(op, x) on the card against the host f64 CSR product."""
    import jax
    import jax.numpy as jnp
    from amg_tpu.ops.spmv import spmv

    x = np.zeros(op.padded_rows, dtype=x_dtype)
    x[: a.n_rows] = np.random.default_rng(11).standard_normal(a.n_rows)
    y = np.asarray(jax.jit(spmv)(op, jnp.asarray(x)))[: a.n_rows]
    err = rel_err(y, a.matvec(x[: a.n_rows].astype(np.float64)))
    say(f"  {name:<26} n={a.n_rows:>8} nnz={a.nnz:>9} "
        f"{precision:<34} rel err {err:.2e} (tol {tol:g})")
    check(err <= tol, f"{name}: relative error {err:.3e} > {tol:g}")
    del op


def coarse_operator(n_target: int = 4096):
    """A Galerkin coarse operator of about ``n_target`` rows (the kind a
    Dense level holds): the level of a poisson3d:48 hierarchy nearest it."""
    import amg_tpu as amg

    hh = amg.setup_host(amg.poisson3d(48), amg.AMGParams(verbose=0),
                        log=lambda *x: None)
    return min(hh.a, key=lambda m: abs(m.n_rows - n_target))


def phase_c(p3d, fem, fr, n2d: int = 512):
    """``fr``: ``fem`` in RCM order, as WEll levels are packed."""
    import jax.numpy as jnp
    import amg_tpu as amg
    from amg_tpu.sparse import Dia, Ell, WEll, Dense, BandedBlocks

    f32, f64 = jnp.float32, jnp.float64
    for dt, tol in ((f32, TOL_F32), (f64, TOL_F64)):
        tag = np.dtype(dt).name
        format_parity(f"Dia {tag} (poisson3d L0)",
                      Dia.from_csr(p3d, dtype=dt), p3d, dt, tol,
                      f"{tag} shifted-slice FMA")
        format_parity(f"Ell {tag} (fem2d)", Ell.from_csr(fem, dtype=dt),
                      fem, dt, tol, f"{tag} gather")
        format_parity(f"WEll {tag} (fem2d, RCM)",
                      WEll.from_csr(fr, dtype=dt), fr, dt, tol,
                      f"{tag} windowed gather")
    format_parity("WEll df64 split (fem2d, RCM)", WEll.from_csr_df64(fr),
                  fr, np.float64, TOL_F64,
                  "f32 hi+lo planes recombined in f64")
    ac = coarse_operator()
    pad = -(-ac.n_rows // 128) * 128
    bnd = amg.poisson2d(n2d)
    for dt, tol in ((f32, TOL_F32), (f64, TOL_F64)):
        tag = np.dtype(dt).name
        format_parity(f"Dense {tag} (coarse level)",
                      Dense.from_csr(ac, dtype=dt, pad_rows_to=pad,
                                     pad_cols_to=pad),
                      ac, dt, tol, f"{tag} matvec, precision=HIGHEST")
        format_parity(f"BandedBlocks {tag} (poisson2d)",
                      BandedBlocks.from_csr(bnd, dtype=dt), bnd, dt, tol,
                      f"{tag} block einsum, precision=HIGHEST")


# ---------------------------------------------------------------------------
# d. main path
# ---------------------------------------------------------------------------


def solve_case(name, a, pars, tol=TOL_SOLVE):
    """Build through AMGSolver, solve twice (the first compiles), and
    verify the true residual on the host."""
    import gc

    import amg_tpu as amg

    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, pars, log=lambda *x: None)
    setup_s = time.perf_counter() - t0
    b = np.ones(a.n_rows)
    _, info_cold = solver.solve(b)
    x, info = solver.solve(b)
    rres = float(np.linalg.norm(b - a.matvec(np.asarray(x, np.float64)))
                 / np.linalg.norm(b))
    fmts = [type(lv.a).__name__ for lv in solver.mg.levels]
    say(f"  {name}: n={a.n_rows} nnz={a.nnz} levels={len(fmts)} "
        f"formats={fmts}")
    say(f"    its={info.nits} setup={setup_s:.2f}s "
        f"solve(first, with compile)={info_cold.solve_seconds:.2f}s "
        f"solve={info.solve_seconds:.3f}s true rres={rres:.3e}  "
        f"[{CARD}]")
    check(rres < tol, f"{name}: true rres {rres:.3e} >= {tol:g}")
    solver.mg = solver.a0_hi = None
    del solver
    gc.collect()
    return info.nits, rres


def phase_d(p3d, fem, n_side: int = 100, fem_spec: str = "fem2d:1000000"):
    from bench import bench_params

    solve_case(f"poisson3d:{n_side} f32 cycles + f64 defect correction",
               p3d, bench_params(n_side, "float32"))
    solve_case(f"poisson3d:{n_side} pure f64",
               p3d, bench_params(n_side, "float64").replace(
                   refine=False, coarse_op_dtype="same"))
    solve_case(f"{fem_spec} FCG, f32 cycles, f64 outer",
               fem, bench_params(0, "float32", matrix_spec=fem_spec))


# ---------------------------------------------------------------------------
# e. reference parity
# ---------------------------------------------------------------------------


def phase_e():
    import amg_tpu as amg
    from amg_tpu.solve.driver import solver_amg

    a = amg.read_mtx(os.path.join(HERE, "tests", "data", "1138_bus.mtx"))
    with open(os.path.join(HERE, "tests", "data", "golden",
                           "resid_1138_bus.json")) as f:
        gold = json.load(f)
    b = np.ones(a.n_rows)
    _, info = solver_amg(a, np.ones(a.n_rows), b, amg.AMGParams(verbose=0),
                         log=lambda *x: None)
    got, want = np.array(info.residuals), np.array(gold["residuals"])
    say(f"  1138_bus f64: its={info.nits} (golden {gold['nits']}), "
        f"rres={info.rres:.6e} (golden {gold['rres']:.6e})")
    check(info.nits == gold["nits"], "iteration count differs from golden")
    check(got.size == want.size, "residual history length differs")
    diff = np.abs(got - want)
    say("  |r_gpu - r_golden| / r_golden per iteration: "
        + " ".join(f"{v:.1e}" for v in diff / want))
    say(f"  worst |r_gpu - r_golden| / r0: {np.max(diff) / want[0]:.2e} "
        f"(floor {GOLDEN_FLOOR:g})")
    check(bool(np.all(diff <= GOLDEN_RTOL * want + GOLDEN_FLOOR * want[0])),
          "residual history drifts from the golden")


# ---------------------------------------------------------------------------
# f. kernel finding
# ---------------------------------------------------------------------------


def time_chain(fn, args, x0, reps: int = 16, min_s: float = 0.3):
    """Seconds per application of ``x <- fn(*args, x)``: a jitted chain of
    ``reps`` applications (an optimization barrier between them keeps
    XLA from fusing neighbours), timed with block_until_ready, best of
    three windows."""
    import jax

    def chain(args, x):
        for _ in range(reps):
            x = jax.lax.optimization_barrier(fn(*args, x))
        return x

    cj = jax.jit(chain)
    x = cj(args, x0).block_until_ready()          # compile + warm
    t0 = time.perf_counter()
    cj(args, x).block_until_ready()
    once = max(time.perf_counter() - t0, 1e-6)
    calls = max(1, int(min_s / once))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            x = cj(args, x)
        x.block_until_ready()
        best = min(best, (time.perf_counter() - t0) / (calls * reps))
    return best


def phase_f(p3d_big, fr):
    import types

    import jax
    import jax.numpy as jnp
    from amg_tpu.sparse import Dia, Ell, WEll
    from amg_tpu.ops.spmv import spmv, residual
    from amg_tpu.solve.smoothers import _masked_group_update

    a = p3d_big
    n = a.n_rows
    d = Dia.from_csr(a, dtype=jnp.float32)
    nd, pad = len(d.offsets), d.padded_rows
    isz = 4
    rng = np.random.default_rng(5)
    x0 = jnp.asarray(rng.standard_normal(pad).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(pad).astype(np.float32))
    diag = np.zeros(pad, np.float32)
    diag[:n] = a.diagonal_fast()
    inv = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1), 0)
    diag_d, inv_d = jnp.asarray(diag), jnp.asarray(inv.astype(np.float32))
    gid = jnp.asarray((np.arange(pad) % 2).astype(np.int32))
    c = np.float32(1.0 / 6.0)

    # device copy of the operator's size: read + write of S bytes
    big = jnp.asarray(rng.standard_normal(nd * pad).astype(np.float32))
    t_copy = time_chain(lambda v: v + np.float32(1.0), (), big)
    copy_bps = 2 * big.size * isz / t_copy

    def gs(dv, dg, iv, gd, bb, v):
        lvl = types.SimpleNamespace(a=dv, diag=dg, inv_diag=iv, gid=gd)
        return _masked_group_update(lvl, v, bb, 0)

    rows = [
        ("Dia SpMV (XLA)", (nd + 2) * pad * isz,
         time_chain(lambda dv, v: spmv(dv, v) * c, (d,), x0)),
        ("Dia residual b - Ax (XLA)", (nd + 3) * pad * isz,
         time_chain(lambda dv, bb, v: residual(dv, v, bb) * c, (d, b), x0)),
        ("Dia masked GS update (XLA)", (nd + 6) * pad * isz,
         time_chain(gs, (d, diag_d, inv_d, gid, b), x0)),
    ]
    say(f"  poisson3d level 0: n={n} nd={nd} f32   [{CARD}]")
    say(f"  device copy {2 * big.size * isz / 1e6:.0f} MB moved: "
        f"{t_copy * 1e3:.3f} ms = {copy_bps / 1e9:.0f} GB/s")
    for name, nbytes, t in rows:
        bps = nbytes / t
        say(f"  {name:<30} {nbytes / 1e6:8.1f} MB {t * 1e3:8.3f} ms "
            f"{bps / 1e9:7.0f} GB/s = {bps / copy_bps:.2f} of copy")
    dia_ratio = rows[0][1] / rows[0][2] / copy_bps
    say(f"  Dia SpMV at {dia_ratio:.2f} of copy: "
        + ("no kernel needed (>= 0.8)" if dia_ratio >= 0.8
           else "below 0.8 — a fused kernel has room"))

    # WEll against plain Ell on the same (RCM-ordered) unstructured level 0
    xf = jnp.asarray(np.random.default_rng(6).standard_normal(
        -(-fr.n_rows // 1024) * 1024).astype(np.float32))
    say(f"  fem2d level 0 (RCM): n={fr.n_rows} nnz={fr.nnz} f32")
    ops = (("Ell SpMV (XLA gather)",
            Ell.from_csr(fr, dtype=jnp.float32, pad_rows_to=xf.shape[0])),
           ("WEll SpMV (XLA windowed gather)",
            WEll.from_csr(fr, dtype=jnp.float32, pad_rows_to=xf.shape[0])))
    for name, op in ops:
        nbytes = sum(v.size * v.dtype.itemsize
                     for v in jax.tree_util.tree_leaves(op)) \
            + 2 * xf.size * isz
        t = time_chain(lambda o, v: spmv(o, v) * np.float32(0.1), (op,), xf)
        say(f"  {name:<30} {nbytes / 1e6:8.1f} MB {t * 1e3:8.3f} ms "
            f"{nbytes / t / 1e9:7.0f} GB/s = {nbytes / t / copy_bps:.2f} "
            f"of copy, {fr.nnz / t / 1e9:.2f} Gnnz/s")

    # the coarsest-level inverse: host LAPACK (what setup runs) against
    # jnp.linalg.inv on the card (cuSOLVER), warm, same operator
    ac = coarse_operator()
    for dt in (np.float32, np.float64):
        dense = ac.to_dense(dt)
        t0 = time.perf_counter()
        np.linalg.inv(dense)
        t_host = time.perf_counter() - t0
        inv_dev = jax.jit(jnp.linalg.inv)
        dev = jnp.asarray(dense)
        inv_dev(dev).block_until_ready()
        t0 = time.perf_counter()
        inv_dev(dev).block_until_ready()
        t_dev = time.perf_counter() - t0
        say(f"  coarse inverse n={ac.n_rows} {np.dtype(dt).name}: host "
            f"LAPACK {t_host * 1e3:.1f} ms, jnp.linalg.inv on the card "
            f"{t_dev * 1e3:.1f} ms")


# ---------------------------------------------------------------------------
# --large and --four
# ---------------------------------------------------------------------------


def run_large(n_side: int = 215):
    import amg_tpu as amg
    from bench import bench_params

    a = amg.poisson3d(n_side)
    solve_case(f"poisson3d:{n_side} FCG (bench parameters)", a,
               bench_params(n_side, "float32"))


def run_four(fem, p3d, fem_spec="fem2d:1000000", n_side=100, ndev=4,
             **fem_overrides):
    """SpmdAMGSolver (general WEll-sharded cycle) on the unstructured
    problem and DistAMGSolver on the structured one, each against the
    single-card solve of the same problem on card 0."""
    import gc

    import amg_tpu as amg
    from amg_tpu.params import SmootherType
    from amg_tpu.parallel import DistAMGSolver, make_mesh
    from amg_tpu.parallel.spmd_cycle import SpmdAMGSolver
    from bench import bench_params

    mesh = make_mesh(ndev)
    say(f"  mesh: {ndev} x {mesh.devices.flat[0].device_kind}   [{CARD}]")
    cases = (
        ("SpmdAMGSolver", SpmdAMGSolver, fem_spec, fem,
         amg.AMGParams(tol=TOL_SOLVE, dtype="float32", refine=True,
                       verbose=0, max_it=100, accel="cg", use_well="on",
                       coarse_smoother=SmootherType.CHEBYSHEV,
                       coarse_op_dtype="float32").replace(**fem_overrides)),
        ("DistAMGSolver", DistAMGSolver, f"poisson3d:{n_side}", p3d,
         bench_params(n_side, "float32")),
    )
    for name, cls, spec, a, pars in cases:
        b = np.ones(a.n_rows)
        its1, _ = solve_case(f"{spec} single card (card 0)", a, pars)
        t0 = time.perf_counter()
        s = cls(a, pars, mesh=mesh, log=lambda *x: None)
        setup_s = time.perf_counter() - t0
        _, info_cold = s.solve(b)
        x, info = s.solve(b)
        rres = float(np.linalg.norm(b - a.matvec(np.asarray(x, np.float64)))
                     / np.linalg.norm(b))
        say(f"  {spec} {name} on {ndev} cards: its={info.nits} "
            f"(card 0: {its1}) setup={setup_s:.2f}s "
            f"solve(first)={info_cold.solve_seconds:.2f}s "
            f"solve={info.solve_seconds:.3f}s true rres={rres:.3e}")
        check(rres < TOL_SOLVE, f"{name}: true rres {rres:.3e}")
        check(abs(info.nits - its1) <= 1,
              f"{name}: {info.nits} its vs {its1} on one card")
        del s
        gc.collect()


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--large", action="store_true",
                      help="only the 9.9M-row poisson3d:215 FCG solve")
    mode.add_argument("--four", action="store_true",
                      help="only the 4-card solvers and their single-card "
                      "comparison")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "amg_tpu")):
        print("chip_smoke: the amg_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    with phase("a. device"):
        dev = phase_a(expect_count=4 if args.four else 1)
    if args.large:
        from amg_tpu.compile_cache import enable

        enable()
        with phase("large: poisson3d:215"):
            run_large()
    elif args.four:
        import amg_tpu as amg
        from amg_tpu.compile_cache import enable
        from amg_tpu.io.generators import fem2d

        enable()
        with phase("four: 4-card solvers vs card 0"):
            run_four(fem2d(1_000_000), amg.poisson3d(100))
    else:
        with phase("b. card-only tests (pytest -m gpu)"):
            phase_b()
        import amg_tpu as amg
        from amg_tpu.compile_cache import enable
        from amg_tpu.io.generators import fem2d

        enable()
        t0 = time.perf_counter()
        p3d = amg.poisson3d(100)
        fem = fem2d(1_000_000)
        fr = rcm(fem)
        say(f"  generated poisson3d:100 and fem2d:1000000 (+ RCM) in "
            f"{time.perf_counter() - t0:.1f} s")
        with phase("c. format parity at real widths"):
            phase_c(p3d, fem, fr)
        with phase("d. main path (AMGSolver, bench parameters)"):
            phase_d(p3d, fem)
        with phase("e. reference parity (1138_bus vs CPU golden)"):
            phase_e()
        with phase("f. kernel finding (XLA rates vs copy)"):
            phase_f(amg.poisson3d(215), fr)
    say(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
