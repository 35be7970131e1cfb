"""Persistent XLA compilation cache.

The reference pays its build cost once at `make` time (build/Makefile); the
JAX analogue is the XLA compile, which is paid per *process*.  Enabling
JAX's persistent compilation cache makes every later process with the same
program shapes skip it, the equivalent of the reference's incremental
rebuild.

Called by the CLI driver (run.py), bench.py, and Simulation; a library user
who wants a different policy can simply set the jax.config knobs before
constructing a Simulation (this helper never overrides an explicit cache
dir, and touches no other knob).
"""

from __future__ import annotations

import os
import sys


def _default_dir() -> str:
    """Repo-local `.jax_cache/` when the package lives in a writable source
    checkout; otherwise a per-user cache dir (a pip install would resolve
    the repo-local path inside site-packages — read-only or shared)."""
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    in_site = any(part in ("site-packages", "dist-packages")
                  for part in pkg_parent.split(os.sep))
    if not in_site and os.access(pkg_parent, os.W_OK):
        return os.path.join(pkg_parent, ".jax_cache")
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "pic1dp_tpu", "xla_cache")


def enable_compilation_cache(path: str | None = None) -> str | None:
    """Idempotently enable the on-disk XLA compile cache.

    Resolution order: explicit `path` argument, then the standard
    JAX_COMPILATION_CACHE_DIR env var (left to jax itself), then a
    `.jax_cache/` directory next to the package (source checkout) or the
    user cache dir (installed package).  Returns the directory in use, or
    None if disabled via PIC1DP_NO_COMPILE_CACHE=1.
    """
    if os.environ.get("PIC1DP_NO_COMPILE_CACHE"):
        return None
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:  # already configured (env var or user code) — respect it
        return current
    if jax.default_backend() == "cpu":
        # CPU AOT executables bake host CPU features (cached on one machine,
        # loaded on another -> possible SIGILL) and CPU compiles are cheap;
        # the cache exists for the minutes-long accelerator compiles
        return None
    cache_dir = path or _default_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
