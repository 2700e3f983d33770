"""Ground-truth reference integrator.

Independent replica of the reference's multithreaded CPU renderer
(src/core/Renderer.cpp:996-1071), kept for the same statistical-validation
role (SURVEY.md §3.3): uniform-hemisphere sampling (no NEE, no MIS), the CPU
GGXCookTorrance BRDF (Renderer.cpp:968-978), termination on emissive hit,
optional sun disk (dot(dir, sunDir) > sunMaxDot, Renderer.cpp:1016-1021),
Russian roulette. Both integrators must converge to the same image; this one
converges slower but has far simpler estimator algebra.

Runs as jitted JAX on CPU or TPU — already vastly faster than the original's
6 pthreads — with a bounce cap instead of an unbounded while(true).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.math.camera import CameraParams, gen_rays
from gpupathtracer_tpu.math.sampling import sample_uniform_hemisphere
from gpupathtracer_tpu.math.vecmath import construct_tbn, dot
from gpupathtracer_tpu.models.interaction import make_interaction, set_incoming
from gpupathtracer_tpu.models.materials import make_material_instance
from gpupathtracer_tpu.models.bsdf import compute_bsdf
from gpupathtracer_tpu.ops.traverse import trace_closest
from gpupathtracer_tpu.scene.envmap import sample_env

T_MAX = 1e20


@partial(jax.jit, static_argnames=("width", "height", "max_bounces",
                                   "stack_depth", "leaf_size", "model",
                                   "traversal", "packet_size", "textured",
                                   "sun"))
def render_sample_reference(scene, cam: CameraParams, pixel_x, pixel_y, key,
                            width: int, height: int,
                            max_bounces: int = 64,
                            stack_depth: int = 48,
                            leaf_size: int = 4,
                            model: str = "trowbridge_reitz",
                            traversal: str = "auto",
                            packet_size: int = 128,
                            textured: bool = False,
                            sun: bool = False):
    """One uniform-hemisphere path per lane; returns [N, 3] radiance."""
    n = pixel_x.shape[0]
    key, k_jitter, k_lens = jax.random.split(key, 3)
    jitter = jax.random.uniform(k_jitter, (n, 2))
    interp = (jnp.stack([pixel_x, pixel_y], axis=-1) + jitter) \
        / jnp.array([width, height], jnp.float32)
    lens_u = jax.random.uniform(k_lens, (n, 2))
    ray_o, ray_d = gen_rays(cam, interp, lens_u)

    class Carry(NamedTuple):
        i: jnp.ndarray
        key: jnp.ndarray
        o: jnp.ndarray
        d: jnp.ndarray
        throughput: jnp.ndarray
        radiance: jnp.ndarray
        alive: jnp.ndarray

    init = Carry(i=jnp.int32(0), key=key, o=ray_o, d=ray_d,
                 throughput=jnp.ones((n, 3), jnp.float32),
                 radiance=jnp.zeros((n, 3), jnp.float32),
                 alive=jnp.ones((n,), bool))

    emissive_mat = jnp.sum(scene.mat_emission, axis=-1) > 1e-5

    def cond(c: Carry):
        return jnp.any(c.alive) & (c.i <= max_bounces)

    def body(c: Carry) -> Carry:
        key, k = jax.random.split(c.key)
        rnd = jax.random.uniform(k, (n, 3))

        hit = trace_closest(scene, c.o, c.d,
                            jnp.full((n,), T_MAX, jnp.float32), c.alive,
                            stack_depth=stack_depth, leaf_size=leaf_size,
                            traversal=traversal, packet_size=packet_size)
        miss = hit.prim < 0
        prim = jnp.maximum(hit.prim, 0)
        normal = scene.tri_normal[prim]
        mat_id = jnp.where(miss, 0, scene.tri_mat[prim])

        # Emissive (or env) hit terminates the path (Renderer.cpp:1014-1030).
        is_emitter = miss | emissive_mat[mat_id]
        env_emission = sample_env(scene.env, c.d)
        if sun:
            # Sun disk on env hit (Renderer.cpp:1016-1021).
            in_disk = jnp.sum(c.d * scene.sun_dir[None, :], axis=-1) \
                > scene.sun_max_dot
            env_emission = env_emission + jnp.where(
                in_disk[..., None], scene.sun_emission[None, :], 0.0)
        emission = jnp.where(miss[..., None], env_emission,
                             scene.mat_emission[mat_id])
        radiance = c.radiance + jnp.where((c.alive & is_emitter)[..., None],
                                          c.throughput * emission, 0.0)
        alive = c.alive & ~is_emitter

        # Bounce: uniform hemisphere (Renderer.cpp:1040-1043).
        pos = c.o + c.d * hit.t[..., None] + 0.001 * normal
        t, b, nn = construct_tbn(normal)
        local = sample_uniform_hemisphere(rnd[:, 0:2])
        new_d = (t * local[..., 0:1] + b * local[..., 1:2]
                 + nn * local[..., 2:3])
        w = 1.0 - hit.u - hit.v
        uvs = scene.tri_uv[prim]
        uv = (uvs[:, 1] * hit.u[..., None] + uvs[:, 2] * hit.v[..., None]
              + uvs[:, 0] * w[..., None])
        mat = make_material_instance(scene, mat_id, uv, textured)
        inter = set_incoming(make_interaction(normal, -c.d), new_d)
        # throughput *= BRDF * 2*pi * ndl (uniform-hemisphere pdf = 1/(2*pi),
        # Renderer.cpp:1052).
        ndl = jnp.maximum(dot(normal, new_d), 0.0)
        throughput = (c.throughput * compute_bsdf(mat, inter, model)
                      * (2.0 * jnp.pi * ndl)[..., None])

        rr = jnp.clip(jnp.max(throughput, axis=-1), 0.0, 1.0)
        kill = rnd[:, 2] > rr
        throughput = throughput / jnp.maximum(rr, 1e-12)[..., None]
        alive = alive & ~kill

        return Carry(i=c.i + 1, key=key, o=pos, d=new_d,
                     throughput=throughput, radiance=radiance, alive=alive)

    final = jax.lax.while_loop(cond, body, init)
    return final.radiance
