"""Worker for the 2-process multi-host test (spawned by test_multihost.py).

Each OS process owns 4 emulated CPU devices; jax.distributed joins them
into one 8-device run, and the row-sharded solve executes across both
processes' device sets — the emulated analog of a 2-host run.
"""

import os
import sys


def main():
    port = sys.argv[1]
    pid = int(sys.argv[2])
    nproc = int(sys.argv[3])
    solver_kind = sys.argv[4] if len(sys.argv) > 4 else "dist"

    import jax

    from amg_tpu.parallel import initialize, is_multiprocess

    assert initialize(coordinator_address=f"localhost:{port}",
                      num_processes=nproc, process_id=pid)
    assert is_multiprocess()
    assert jax.process_count() == nproc

    import numpy as np
    import amg_tpu as amg
    from amg_tpu.params import AMGParams, SmootherType
    from amg_tpu.parallel import DistAMGSolver, SpmdAMGSolver, make_mesh

    a = amg.poisson2d(24)
    pars = AMGParams(verbose=0, smoother=SmootherType.L1DIAG)
    b = np.ones(a.n_rows)
    mesh = make_mesh()  # all devices of all processes
    assert mesh.devices.size == jax.device_count()
    cls = DistAMGSolver if solver_kind == "dist" else SpmdAMGSolver
    solver = cls(a, pars, mesh=mesh, log=lambda *a: None)
    x, info = solver.solve(b)
    r = b - a.matvec(np.asarray(x, dtype=np.float64))
    true_rres = float(np.linalg.norm(r) / np.linalg.norm(b))
    # one machine-readable line per process, parsed by the test
    print(f"RESULT pid={pid} nits={info.nits} rres={info.rres:.6e} "
          f"true_rres={true_rres:.6e} xsum={float(np.sum(x)):.12e}",
          flush=True)


if __name__ == "__main__":
    main()
