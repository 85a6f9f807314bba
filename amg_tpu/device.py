"""What the solve runs on: the GPU check, the card's description and the
peak rates that measured rates are set against."""

from __future__ import annotations

import subprocess

# Device-memory bandwidth peaks in bytes/s, keyed by ``device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 80 GB HBM3:
# 3.35 TB/s; PCIe 80 GB HBM2e: 2.0 TB/s).
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def hbm_peak(kind: str) -> float:
    """Published memory bandwidth of ``kind``; an unknown device is an
    error, never a default."""
    try:
        return HBM_PEAK_BYTES_PER_S[kind]
    except KeyError:
        raise KeyError(f"no memory-bandwidth peak recorded for device "
                       f"kind {kind!r}; add it to "
                       "amg_tpu.device.HBM_PEAK_BYTES_PER_S") from None


def card_line() -> str:
    """``name, power.limit`` of every card as nvidia-smi reports them
    (a child process; never touches JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def describe() -> dict:
    """Platform, kind and count of the devices JAX sees."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """:func:`describe`, or ``SystemExit`` when JAX found no GPU: a
    measurement taken on the CPU is not a device number."""
    d = describe()
    if d["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {d['platform']} "
                         f"({d['kind']}); this measures the GPU only")
    return d
