"""Next-event estimation: emitter sampling from the cumulative-area CDF.

Rebuild of RandomLightVertex + GenerateLightSample (src/shaders/
Iterative.comp:34-147). The per-thread CDF binary search becomes a
vectorized `jnp.searchsorted`; the pdf/MIS algebra is replicated exactly
(Veach eq. 9 solid-angle conversion, balance heuristic, the area-measure
light pdf 1/totalLightArea; the SUN_LIGHT branch is compiled out in the
reference and optional here).

Scenes with zero emitters degrade gracefully exactly like the reference:
totalLightArea = 0 makes lightPdf infinite and every NEE term zero.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from gpupathtracer_tpu.math.sampling import sample_triangle_barycentrics
from gpupathtracer_tpu.math.vecmath import avdot, dot
from gpupathtracer_tpu.models.bsdf import compute_bsdf, mis_weight
from gpupathtracer_tpu.models.interaction import SurfaceInteraction, set_incoming
from gpupathtracer_tpu.models.materials import MaterialInstance
from gpupathtracer_tpu.models.microfacet import pdf_direction


class LightSample(NamedTuple):
    shadow_origin: jnp.ndarray   # [N, 3]
    shadow_dir: jnp.ndarray      # [N, 3]
    shadow_tmax: jnp.ndarray     # [N]
    throughput: jnp.ndarray      # [N, 3] (already MIS-weighted, / pdf)
    emission: jnp.ndarray        # [N, 3] emitter radiance


def sample_light_vertex(scene, u_select, u_tri):
    """RandomLightVertex (Iterative.comp:34-82): CDF search + sqrt warp.

    Returns (position, normal, emission), all read from ONE gather of the
    packed per-emitter light_rows table (in place of 5 separate row
    gathers: tri id, geometry, normal, mat id, emission)."""
    selected = u_select * scene.total_light_area
    i = jnp.searchsorted(scene.light_cdf, selected, side="right")
    i = jnp.clip(i, 0, scene.light_rows.shape[0] - 1).astype(jnp.int32)
    row = scene.light_rows[i]                   # [N, 16]
    p0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    bu, bv, bt = sample_triangle_barycentrics(u_tri)
    # Position = p0*u + p1*v + p2*t with p1 = p0+e1, p2 = p0+e2
    # (Iterative.comp:62-76) => p0 + e1*v + e2*t.
    pos = p0 + e1 * bv[..., None] + e2 * bt[..., None]
    return pos, row[..., 9:12], row[..., 12:15]


def sample_sun_vertex(scene, vertex_pos, u_disk):
    """RandomSunVertex (Iterative.comp:93-110): a disk of radius
    tan(angular_radius) centered one unit along sunDir from the vertex."""
    from gpupathtracer_tpu.math.vecmath import construct_tbn
    n = -scene.sun_dir
    t, b, nn = construct_tbn(jnp.broadcast_to(n, vertex_pos.shape))
    radius = scene.sun_radius * jnp.sqrt(u_disk[..., 0])
    phi = 2.0 * jnp.pi * u_disk[..., 1]
    disk = (t * (radius * jnp.cos(phi))[..., None]
            + b * (radius * jnp.sin(phi))[..., None])
    pos = vertex_pos + scene.sun_dir[None, :] + disk
    return pos, jnp.broadcast_to(n, vertex_pos.shape)


def sample_sun_cone(scene, shape, u):
    """Uniform direction in the sun's solid-angle cone (half-angle =
    sun_angle). The principled replacement for the reference's unit-distance
    disk, which it calls "very hacky" (Iterative.comp:84-88): the disk's
    area pdf only approximates the cone's solid-angle measure for small
    angles and breaks MIS weights for large suns.

    Returns (direction toward the sun [..., 3], solid-angle pdf scalar)."""
    from gpupathtracer_tpu.math.vecmath import construct_tbn, normalize
    cos_t = 1.0 - u[..., 0] * (1.0 - scene.sun_max_dot)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * jnp.pi * u[..., 1]
    axis = jnp.broadcast_to(normalize(scene.sun_dir), shape)
    t, b, n = construct_tbn(axis)
    direction = (t * (sin_t * jnp.cos(phi))[..., None]
                 + b * (sin_t * jnp.sin(phi))[..., None]
                 + n * cos_t[..., None])
    pdf = 1.0 / (2.0 * jnp.pi * jnp.maximum(1.0 - scene.sun_max_dot, 1e-12))
    return direction, pdf


def generate_light_sample(scene, vertex_pos, vertex_normal,
                          mat: MaterialInstance, inter: SurfaceInteraction,
                          throughput, u_select, u_tri,
                          model: str = "trowbridge_reitz",
                          sun: bool = False,
                          sun_mode: str = "disk",
                          u_pick=None) -> LightSample:
    """GenerateLightSample (Iterative.comp:113-147). With `sun` (the
    reference's SUN_LIGHT branch, compiled out there by default): 50/50
    pick between the emitter CDF and the sun, pdfs 0.5/totalLightArea and
    0.5/sunArea (Iterative.comp:116-126). sun_mode="disk" replicates the
    reference's unit-distance disk; "cone" samples the true solid angle
    (see sample_sun_cone)."""
    light_pos, light_n, emission = sample_light_vertex(scene, u_select,
                                                       u_tri)
    delta = light_pos - vertex_pos
    radius = jnp.sqrt(jnp.maximum(dot(delta, delta), 1e-20))
    light_pdf = 1.0 / scene.total_light_area  # inf when no emitters -> NEE = 0
    shadow_tmax = radius - 0.005

    if sun and sun_mode == "cone":
        sun_dir, sun_pdf = sample_sun_cone(scene, vertex_pos.shape, u_tri)
        pick_area = u_pick > 0.5
        # Pseudo light vertex one unit away, facing back: radius = 1 and
        # cos_light = 1, so the area-measure factors below reduce to the
        # solid-angle estimator for the sun lanes.
        light_pos = jnp.where(pick_area[..., None], light_pos,
                              vertex_pos + sun_dir)
        light_n = jnp.where(pick_area[..., None], light_n, -sun_dir)
        emission = jnp.where(pick_area[..., None], emission,
                             scene.sun_emission[None, :])
        delta = light_pos - vertex_pos
        radius = jnp.where(pick_area,
                           jnp.sqrt(jnp.maximum(dot(delta, delta), 1e-20)),
                           1.0)
        light_pdf = jnp.where(pick_area, 0.5 / scene.total_light_area,
                              0.5 * sun_pdf)
        shadow_tmax = jnp.where(pick_area, radius - 0.005, 1e20)
    elif sun:
        sun_pos, sun_n = sample_sun_vertex(scene, vertex_pos, u_tri)
        sun_area = jnp.pi * scene.sun_radius * scene.sun_radius
        pick_area = u_pick > 0.5  # Iterative.comp:117-118
        light_pos = jnp.where(pick_area[..., None], light_pos, sun_pos)
        light_n = jnp.where(pick_area[..., None], light_n, sun_n)
        emission = jnp.where(pick_area[..., None], emission,
                             scene.sun_emission[None, :])
        delta = light_pos - vertex_pos
        radius = jnp.sqrt(jnp.maximum(dot(delta, delta), 1e-20))
        light_pdf = jnp.where(pick_area, 0.5 / scene.total_light_area,
                              0.5 / sun_area)
        shadow_tmax = jnp.where(pick_area, radius - 0.005, 1e20)

    light_dir = delta / radius[..., None]
    inter_l = set_incoming(inter, light_dir)
    cos_light = avdot(light_n, -light_dir)
    r2 = radius * radius
    bounce_pdf = pdf_direction(mat, inter_l, model) * cos_light / r2  # Veach eq. 9
    weight = mis_weight(light_pdf, bounce_pdf)
    light_throughput = (throughput * compute_bsdf(mat, inter_l, model)
                        * (inter_l.ndi * cos_light * weight
                           / (light_pdf * r2))[..., None])

    return LightSample(
        shadow_origin=vertex_pos + 0.001 * inter.normal,
        shadow_dir=light_dir,
        shadow_tmax=shadow_tmax,
        throughput=light_throughput,
        emission=emission,
    )
