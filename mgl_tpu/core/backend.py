"""Where the DP runs: the hand-written GPU kernels or the plain JAX path.

One decision for every entry point (SmithWatermanAligner, PairHmmEngine,
the mapper, parallel.pipeline): ``impl="auto"`` takes the Pallas kernels
in ``mgl_tpu/kernels/`` when JAX's default device is a GPU, and the
``lax.scan`` specifications in ``mgl_tpu/ops/`` otherwise.
``MGL_TPU_IMPL=xla`` forces the plain path everywhere, which is how the
two are timed against each other on the card.  Interpret mode is never
chosen here: tests pass ``interpret=True`` to a kernel themselves.

Also here: the persistent compile cache location shared by every script
that compiles at real widths.
"""

from __future__ import annotations

import os
import pathlib

IMPLS = ("auto", "pallas", "xla")

# <checkout>/.jax_cache: a fixed path, so a later process finds what an
# earlier one compiled (the path is part of the cache key)
CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def check_impl(impl: str) -> str:
    """``impl`` itself, or ValueError when it is not one of IMPLS."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def resolve_impl(impl: str = "auto") -> str:
    """'pallas' (GPU kernels) or 'xla' (plain JAX) for an ``impl=``
    argument; 'auto' follows MGL_TPU_IMPL, then the device platform."""
    if check_impl(impl) != "auto":
        return impl
    if os.environ.get("MGL_TPU_IMPL") == "xla":
        return "xla"
    import jax

    return "pallas" if jax.devices()[0].platform == "gpu" else "xla"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is changed here; otherwise the cache goes to <checkout>/.jax_cache.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
