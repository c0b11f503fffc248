"""Multi-chip rendering: ray/pixel sharding over a jax.sharding.Mesh.

The reference's only parallelism is rayon work-stealing over 16×16 film
tiles with a mutex-guarded merge (/root/reference/src/render.rs:19-47).
The replacement is SPMD data parallelism over rays:

  * the pixel batch is sharded across the mesh's 'rays' axis with
    `shard_map`; every device renders its own pixel slab;
  * scene geometry, BVH, textures, and params are REPLICATED (the
    BASELINE.json north star: geometry+textures replicated per device);
  * per-device partial films are disjoint, so the "merge" is just the
    sharded output layout — no mutex, no collective on the forward path;
  * for inverse rendering, per-device loss/gradients are all-reduced with
    `psum` inside the same shard_map (an NCCL collective on GPUs — the
    analog of the reference's nonexistent gradient sync, and the pattern
    that scales to several hosts via jax.distributed).

Determinism: each ray's Halton stream depends only on (pixel, sample), so
device count does not change the image.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def make_mesh(n_devices: Optional[int] = None, axis: str = "rays") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def render_chunk_sharded(plan, mesh: Mesh, params, pix_offsets, pix_xy):
    """Sharded version of render._render_chunk: the pixel axis is split
    across the mesh; params/scene are replicated. Output is the full film
    chunk (C, 3) laid out sharded over devices."""
    from curry_pbrt_tpu.render import _render_chunk

    fn = shard_map(
        partial(_render_chunk, plan),
        mesh=mesh,
        in_specs=(P(), P("rays"), P("rays")),
        out_specs=P("rays"),
        check_vma=False,
    )
    return fn(params, pix_offsets, pix_xy)


def make_sharded_render(plan, mesh: Mesh):
    """jit-compiled sharded chunk renderer."""
    return jax.jit(partial(render_chunk_sharded, plan, mesh))


def make_sharded_train_step(plan, mesh: Mesh, optimizer, param_labels=None):
    """Inverse-rendering step: per-device forward+backward on its ray slab,
    gradient all-reduce via psum over the mesh, replicated optimizer update.

    optimizer: an optax GradientTransformation. Returns step(params,
    opt_state, target, pix_offsets, pix_xy) → (params, opt_state, loss).
    """
    import optax
    from curry_pbrt_tpu.render import _render_chunk

    def device_grads(params, target, po, px):
        def loss_fn(p):
            img = _render_chunk(plan, p, po, px)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        # all-reduce across chips: mean so the update is device-count
        # invariant
        loss = jax.lax.pmean(loss, "rays")
        grads = jax.lax.pmean(grads, "rays")
        return loss, grads

    sharded_grads = shard_map(
        device_grads,
        mesh=mesh,
        in_specs=(P(), P("rays"), P("rays"), P("rays")),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(params, opt_state, target, po, px):
        loss, grads = sharded_grads(params, target, po, px)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
