"""Multi-host (multi-process) operation.

The reference is strictly single-process (SURVEY.md section 0); running one
solve across several hosts is a capability this framework adds, following
the standard JAX multi-controller recipe:

* every process runs the SAME program (SPMD at the controller level),
* :func:`initialize` wires the processes together via
  ``jax.distributed.initialize`` (Gloo/TCP coordination on CPU, NCCL on
  GPUs),
* after initialization ``jax.devices()`` returns the GLOBAL device list in
  process order, so the existing 1-D row-partition mesh
  (:func:`~amg_tpu.parallel.dist.make_mesh`) transparently spans hosts.

Intra- vs inter-host axis plan
------------------------------
``jax.devices()`` orders devices process-by-process, so a flat 1-D mesh
axis ``'x'`` gives every host one CONTIGUOUS block of matrix rows.  The
ring halo exchanges of the row-partitioned SpMV
(:mod:`~amg_tpu.parallel.halo`) are nearest-neighbor ``ppermute`` s along
that axis: all hops between two shards of the same host stay on the
host's device interconnect, and only the one boundary hop per host pair
crosses the network — O(halo width) bytes per cycle, the cheapest
inter-host footprint for a 1-D partition.  Global reductions (``psum``
dots/norms in CG and the residual check) are hierarchical under XLA:
intra-host partials reduce before the cross-host exchange.  For hybrid
meshes :func:`make_host_mesh` exposes an explicit ``('host', 'chip')`` 2-D
mesh where sharding annotations can keep an axis inter-host-only or
intra-host-only.

The multi-host path is exercised by ``tests/test_multihost.py`` and ``bench_dist.py
--spawn``, which launch N real OS processes with emulated CPU devices and
run the full sharded solve across them.
"""

from __future__ import annotations

import os

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               **kwargs) -> bool:
    """Wire this process into a multi-process JAX run.

    Thin wrapper over ``jax.distributed.initialize`` with environment
    fallbacks (``AMG_COORDINATOR``, ``AMG_NUM_PROCESSES``,
    ``AMG_PROCESS_ID``) so launchers can configure workers without code.
    Returns True when multi-process mode was (or already is) active.
    No-op when neither arguments nor environment ask for it, and when the
    runtime was already initialized (idempotent).
    """
    import jax

    # do NOT probe jax.process_count() here: it initializes the XLA
    # backend, after which jax.distributed.initialize refuses to run
    from jax._src import distributed as _jdist

    if getattr(_jdist.global_state, "client", None) is not None:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "AMG_COORDINATOR")
    if num_processes is None and "AMG_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["AMG_NUM_PROCESSES"])
    if process_id is None and "AMG_PROCESS_ID" in os.environ:
        process_id = int(os.environ["AMG_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    return True


def is_multiprocess() -> bool:
    import jax

    return jax.process_count() > 1


def fetch(x) -> np.ndarray:
    """Global ``jax.Array`` → host numpy, correct on any process count.

    Single-process arrays (and fully-addressable ones) fetch directly;
    arrays whose shards live on other hosts go through
    ``multihost_utils.process_allgather`` so every process returns the
    same full value (the AMG drivers hand the user the whole solution
    vector, reference surface ``amg/SSS_main.c:152-154``).
    """
    import jax

    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def make_host_mesh(axes: tuple[str, str] = ("host", "chip")):
    """2-D ``(n_processes, devices_per_process)`` mesh.

    Row-partition solvers use the flat 1-D mesh (see module docstring);
    this explicit host axis is for shardings that must distinguish
    inter-host from intra-host communication (e.g. replicating the coarse
    tail per-host instead of per-chip).
    """
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()).reshape(
        jax.process_count(), -1)
    return Mesh(devs, axes)
