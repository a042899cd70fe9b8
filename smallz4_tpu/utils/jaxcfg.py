"""Process-wide JAX configuration for the framework.

Importing this module enables the persistent compilation cache so the
fixed-shape codec kernels (chunk matcher at 4 MB groups, decoder
expansion) compile once per machine, not once per process.  The cache
lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set (JAX reads
that variable itself), else at the fixed ``<repo>/.jax_cache``."""
from __future__ import annotations

import os
import pathlib

import jax

DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def setup() -> None:
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


setup()
