"""The device a run measures or renders on, and the refusal to fall back.

Measurement entry points (bench.py, chip_smoke.py, the tools) need a GPU
and stop when JAX finds none. The CLI renders on the host only when the
user asks for it with JAX_PLATFORMS=cpu, never as a silent fallback.
"""

from __future__ import annotations

import os
import subprocess


def nvidia_smi_card() -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "not available" where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.splitlines()[0] if out else "not available"


def device_record() -> dict:
    """platform / device_kind / count as JAX reports them, plus the card."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": nvidia_smi_card(),
    }


def require_gpu(what: str) -> None:
    """Stop unless JAX's default backend is a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"{what} needs a GPU; JAX found {backend!r}")


def require_render_device() -> None:
    """Stop unless there is a GPU, or the host CPU was asked for."""
    import jax

    if jax.default_backend() == "cpu" and os.environ.get("JAX_PLATFORMS") == "cpu":
        return
    require_gpu("rendering (set JAX_PLATFORMS=cpu to render on the host)")
