"""Persistent XLA compile cache at a fixed place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
:func:`enable` leaves every setting alone.  Otherwise the cache lives in
``<checkout>/.jax_cache/<host fingerprint>``: a fixed path (the path is
part of what makes a later run hit) inside the checkout.

The fingerprint (machine arch, CPU flags, jax version) keeps hosts apart:
JAX's persistent cache does not key CPU-backend entries by the host's
feature set, and an entry AOT-compiled on one machine fails to load on
another ("Target machine feature ... is not supported on the host
machine"), after which XLA recompiles on every run without replacing the
stale entry.
"""

from __future__ import annotations

import hashlib
import os
import platform

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_fingerprint() -> str:
    parts = [platform.machine()]
    try:
        import jax

        parts.append(jax.__version__)
    except Exception:  # pragma: no cover
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(line.strip())
                    break
    except OSError:  # pragma: no cover - non-Linux
        parts.append(platform.processor())
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def cache_dir() -> str:
    """The directory :func:`enable` points JAX at."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return os.path.join(_REPO_ROOT, ".jax_cache", _host_fingerprint())


def enable(min_compile_secs: float = 0.5) -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set this changes nothing: JAX has
    taken the directory from the environment at import."""
    d = cache_dir()
    if os.environ.get(ENV_VAR):
        return d
    import jax

    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return d
