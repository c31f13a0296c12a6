"""Persistent XLA compilation cache.

JAX's persistent compilation cache serializes compiled executables keyed by
(HLO, compile options, backend version), so the second run of the same
config loads its programs instead of recompiling them.

``enable()`` is called by ``bench.py``, ``chip_smoke.py`` and the training
CLI (theanet_tpu/train.py) before any lowering happens. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at start-up and this
module sets no other directory. Otherwise the cache lives at the fixed
``<checkout>/.jax_compile_cache`` (gitignored): the path is part of what a
later run must find, so it never moves.

Reference counterpart: none — Theano's own on-disk cache (~/.theano) gave
the reference warm-start compiles; this is the JAX/XLA equivalent.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_compile_cache",
)


def enable() -> str:
    """Make sure JAX's persistent compilation cache is on; returns the
    directory in effect. Must run before the first compilation to catch
    it; later calls are harmless."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
