"""The one device-capability decision of the package.

Engine choice (engine/run.py) and batch geometry (engine/planner.py) ask
whether JAX's default backend is an accelerator.  Any platform but the
CPU counts: the code paths are plain JAX and compile for every backend.
"""

from __future__ import annotations


def on_accelerator() -> bool:
    """True when JAX's default backend is not the CPU.

    Initialises the backend; a failure to do so propagates (a broken
    device setup must not silently pick the CPU paths)."""
    import jax

    return jax.devices()[0].platform != "cpu"
