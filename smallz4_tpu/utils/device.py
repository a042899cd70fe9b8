"""What JAX runs on: the one place the program asks which device it has."""
from __future__ import annotations


def info() -> dict:
    """{"platform", "kind", "count"} of the default backend's devices, as
    JAX reports them (``platform`` is "gpu" on an NVIDIA card, "cpu" on
    the host backend)."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
