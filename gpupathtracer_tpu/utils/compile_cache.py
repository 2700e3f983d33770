"""Persistent XLA compilation cache.

Role of the reference's instant startup (precompiled GLSL is cached by the
GL driver): every entry point enables JAX's persistent compilation cache,
so the second run of any shape loads its executable from disk.

Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps the cache there and this
module sets no directory. Otherwise the cache lives at one fixed path in the
checkout, cache/xla, so every run from the checkout finds it again.
"""

from __future__ import annotations

import os

from gpupathtracer_tpu.utils.paths import cache_path


def enable_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if not path:
        path = cache_path("xla")
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything, not just slow compiles: dispatch-heavy progressive
    # rendering re-jits many small shapes.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
