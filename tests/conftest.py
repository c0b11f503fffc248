"""Test harness: an 8-device virtual CPU platform, so sharding tests run
without a multi-GPU host.

`jax.config.update('jax_platforms', ...)` works at any point before backend
initialization, and XLA_FLAGS is set before the first jax.devices() call.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# persistent compilation cache: render-chunk compiles dominate test time
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

from curry_pbrt_tpu.utils.cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()
