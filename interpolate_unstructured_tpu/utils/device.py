"""Which device a measurement ran on.

Every number the benchmarks and ``chip_smoke.py`` print names its
device: JAX's platform, ``device_kind`` and device count, plus the
card's name and power limit as ``nvidia-smi`` reports them (a card set
below its maximum power runs slower under load).  A measurement path
that finds no GPU stops; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """``name, power.limit`` of each card, one line per card, read by
    ``nvidia-smi`` in a child process that never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi unavailable: {e}") from e
    return out.stdout.strip()


def require_gpu() -> dict:
    """The JAX device description, or SystemExit when JAX found no GPU.

    Returns ``{"platform", "kind", "count"}`` as JAX reports them
    (``jax.devices()[0].platform``, ``.device_kind``,
    ``len(jax.devices())``)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {len(devices)} {devices[0].platform!r} "
            "device(s); this measurement runs only on the card"
        )
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
