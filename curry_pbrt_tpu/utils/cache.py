"""JAX persistent compilation cache location.

One rule for every entry point (CLI, bench, chip smoke, tools, tests): if
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing else is
set; otherwise the cache lives in `.jax_cache/` at the checkout's root, a
fixed path, so a later process on the same checkout hits it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping

REPO_ROOT = Path(__file__).resolve().parents[2]
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> Path:
    """The cache directory the rule above selects."""
    return Path(environ.get(ENV_VAR) or REPO_ROOT / ".jax_cache")


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
