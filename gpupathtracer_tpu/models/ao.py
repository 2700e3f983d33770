"""Ambient-occlusion integrator.

Not in the reference (its debug modes were #define flips and debug SSBO
dumps); included as a fast geometry/BVH-quality inspection mode: one
closest hit + one cosine-sampled occlusion ray with a finite radius.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.math.camera import CameraParams, gen_rays
from gpupathtracer_tpu.math.sampling import sample_cosine_hemisphere
from gpupathtracer_tpu.math.vecmath import construct_tbn
from gpupathtracer_tpu.ops.traverse import trace_closest, trace_occluded

T_MAX = 1e20


@partial(jax.jit, static_argnames=("width", "height", "stack_depth",
                                   "leaf_size", "traversal", "packet_size",
                                   "radius"))
def render_sample_ao(scene, cam: CameraParams, pixel_x, pixel_y, key,
                     width: int, height: int,
                     stack_depth: int = 48, leaf_size: int = 4,
                     traversal: str = "auto", packet_size: int = 128,
                     radius: float = 2.0):
    """One AO sample per pixel; returns ([N, 3] grey radiance, rays)."""
    n = pixel_x.shape[0]
    key, k_jitter, k_dir = jax.random.split(key, 3)
    jitter = jax.random.uniform(k_jitter, (n, 2))
    interp = (jnp.stack([pixel_x, pixel_y], axis=-1) + jitter) \
        / jnp.array([width, height], jnp.float32)
    o, d = gen_rays(cam, interp, jnp.zeros((n, 2)))

    active = jnp.ones((n,), bool)
    hit = trace_closest(scene, o, d, jnp.full((n,), T_MAX, jnp.float32),
                        active, stack_depth=stack_depth, leaf_size=leaf_size,
                        traversal=traversal, packet_size=packet_size)
    surf = hit.prim >= 0
    prim = jnp.maximum(hit.prim, 0)
    normal = scene.tri_normal[prim]
    # Flip toward the viewer so AO works from both sides.
    normal = jnp.where(jnp.sum(normal * d, axis=-1, keepdims=True) > 0,
                       -normal, normal)
    pos = o + d * hit.t[..., None] + 0.003 * normal

    u = jax.random.uniform(k_dir, (n, 2))
    t, b, nn = construct_tbn(normal)
    local = sample_cosine_hemisphere(u)
    ao_dir = t * local[..., 0:1] + b * local[..., 1:2] + nn * local[..., 2:3]
    occluded = trace_occluded(scene, pos + 0.001 * normal, ao_dir,
                              jnp.full((n,), radius, jnp.float32),
                              surf, stack_depth=stack_depth,
                              leaf_size=leaf_size, traversal=traversal,
                              packet_size=packet_size)
    # Sky for misses, visibility for surfaces.
    value = jnp.where(surf, (~occluded).astype(jnp.float32), 1.0)
    rays = jnp.sum(active, dtype=jnp.int32) + jnp.sum(surf, dtype=jnp.int32)
    return jnp.repeat(value[:, None], 3, axis=1), rays
