"""Multi-host (2-process) tests.

Spawns two real OS processes, each with 4 emulated CPU devices, joined by
``jax.distributed`` into one 8-device run — the emulated analog of a
2-host cluster (SURVEY.md section 4: "multi-host tests using
jax.distributed with CPU devices").  The reference has no distributed
mode at all (SURVEY.md section 0); this is framework-added capability.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_mh_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(nproc: int, solver_kind: str, timeout: float = 600.0):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO,
    )
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(i), str(nproc),
             solver_kind],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO,
        )
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    results = []
    for out in outs:
        m = re.search(
            r"RESULT pid=(\d+) nits=(\d+) rres=(\S+) true_rres=(\S+) "
            r"xsum=(\S+)", out)
        assert m, f"no RESULT line in worker output:\n{out}"
        results.append(dict(pid=int(m.group(1)), nits=int(m.group(2)),
                            rres=float(m.group(3)),
                            true_rres=float(m.group(4)),
                            xsum=float(m.group(5))))
    return results


@pytest.mark.slow
def test_two_process_dist_solver():
    res = _run_workers(2, "dist")
    assert {r["pid"] for r in res} == {0, 1}
    for r in res:
        assert r["true_rres"] < 1e-6
    # both controllers observe the identical global solve
    assert res[0]["nits"] == res[1]["nits"]
    np.testing.assert_allclose(res[0]["xsum"], res[1]["xsum"], rtol=1e-12)


@pytest.mark.slow
def test_two_process_matches_single_process():
    import jax

    if jax.process_count() > 1:  # pragma: no cover
        pytest.skip("outer test process already multi-process")
    import amg_tpu as amg
    from amg_tpu.params import AMGParams, SmootherType

    a = amg.poisson2d(24)
    pars = AMGParams(verbose=0, smoother=SmootherType.L1DIAG)
    x1, info1 = amg.AMGSolver(a, pars).solve(np.ones(a.n_rows))

    res = _run_workers(2, "dist")
    assert abs(res[0]["nits"] - info1.nits) <= 1
    np.testing.assert_allclose(res[0]["xsum"], float(np.sum(x1)), rtol=1e-8)
