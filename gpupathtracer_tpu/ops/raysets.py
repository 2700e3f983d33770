"""Ray sets and hit comparison for checking and timing traversals.

Three sets per camera view, the three queries every rendered frame makes:
  primary  one camera ray per pixel, jittered inside the pixel as the
           renderer's are, in the film's Morton order;
  bounce   one diffuse bounce from each primary hit (cosine-weighted about
           the normal that faces the ray, origin offset 0.003 * normal as
           the wavefront integrator does), inactive where the primary missed;
  shadow   the NEE segment from each primary hit to a point sampled on the
           emitters (models/nee.py sample_light_vertex), any-hit queries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.math.camera import gen_rays
from gpupathtracer_tpu.math.sampling import sample_cosine_hemisphere
from gpupathtracer_tpu.math.vecmath import construct_tbn
from gpupathtracer_tpu.models.nee import sample_light_vertex
from gpupathtracer_tpu.ops.traverse import closest_hit
from gpupathtracer_tpu.utils.morton import ray_order


def make_ray_sets(scene, cam, width: int, height: int, *, stack_depth: int,
                  leaf_size: int, seed: int = 0):
    """{"primary"|"bounce"|"shadow": (o, d, t_max, active)} device arrays.

    Primary hits come from the per-lane reference traversal, so the sets
    do not depend on the traversal under test."""
    order = ray_order(width, height, "morton")
    px = jnp.asarray((order % width).astype(np.float32))
    py = jnp.asarray((order // width).astype(np.float32))
    n = px.shape[0]
    k_jit, k_lens, k_dir, k_sel, k_tri = jax.random.split(
        jax.random.PRNGKey(seed), 5)
    interp = ((jnp.stack([px, py], -1) + jax.random.uniform(k_jit, (n, 2)))
              / jnp.array([width, height], jnp.float32))
    o, d = gen_rays(cam, interp, jax.random.uniform(k_lens, (n, 2)))
    t_max = jnp.full((n,), 1e20, jnp.float32)
    everyone = jnp.ones((n,), bool)
    hit = closest_hit(scene.bvh, scene.tri_geom, o, d, t_max, everyone,
                      stack_depth=stack_depth, leaf_size=leaf_size)
    found = hit.prim >= 0
    normal = scene.tri_shade[jnp.maximum(hit.prim, 0), 0:3]
    normal = jnp.where(jnp.sum(normal * d, -1, keepdims=True) > 0,
                       -normal, normal)
    pos = o + d * jnp.where(found, hit.t, 0.0)[:, None]

    t_, b_, n_ = construct_tbn(normal)
    local = sample_cosine_hemisphere(jax.random.uniform(k_dir, (n, 2)))
    bounce_d = (t_ * local[:, 0:1] + b_ * local[:, 1:2]
                + n_ * local[:, 2:3])
    bounce_o = pos + 0.003 * normal

    light_p, _, _ = sample_light_vertex(
        scene, jax.random.uniform(k_sel, (n,)),
        jax.random.uniform(k_tri, (n, 2)))
    shadow_o = pos + 0.001 * normal
    seg = light_p - shadow_o
    dist = jnp.sqrt(jnp.maximum(jnp.sum(seg * seg, -1), 1e-20))
    shadow_d = seg / dist[:, None]
    return {
        "primary": (o, d, t_max, everyone),
        "bounce": (bounce_o, bounce_d, t_max, found),
        "shadow": (shadow_o, shadow_d, dist * 0.999, found),
    }


def compare_hits(ref_t, ref_prim, t, prim, active) -> dict:
    """Disagreements of a closest-hit result with a reference, over the
    active lanes: hit/miss, t beyond rtol 1e-5 / atol 1e-5 where both hit,
    and prim where both hit at distinct t (equal t is a tie between
    triangles, which either traversal may resolve)."""
    ref_t, ref_prim, t, prim, active = (np.asarray(a) for a in
                                        (ref_t, ref_prim, t, prim, active))
    both = active & (ref_prim >= 0) & (prim >= 0)
    hitmiss = int(np.sum(active & ((ref_prim >= 0) != (prim >= 0))))
    t_bad = int(np.sum(both & ~np.isclose(t, ref_t, rtol=1e-5, atol=1e-5)))
    tie = np.isclose(t, ref_t, rtol=1e-6, atol=1e-6)
    prim_bad = int(np.sum(both & (prim != ref_prim) & ~tie))
    n = int(np.sum(active))
    return {"rays": n, "hit_miss": hitmiss, "t": t_bad, "prim": prim_bad,
            "share": (hitmiss + t_bad + prim_bad) / max(n, 1)}


def compare_occlusion(ref_t, t_max, occluded, active) -> dict:
    """Disagreements of any-hit results with `closest t < t_max`."""
    ref_t, t_max, occluded, active = (np.asarray(a) for a in
                                      (ref_t, t_max, occluded, active))
    bad = int(np.sum(active & (occluded != (ref_t < t_max))))
    n = int(np.sum(active))
    return {"rays": n, "occlusion": bad, "share": bad / max(n, 1)}
