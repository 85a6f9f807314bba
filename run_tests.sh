#!/bin/sh
# CPU test runner: emulates 8 devices for the sharding tests.
exec env JAX_PLATFORMS=cpu \
  XLA_FLAGS="--xla_force_host_platform_device_count=8" \
  python -m pytest "$@"
