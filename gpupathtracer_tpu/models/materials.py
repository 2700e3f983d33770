"""Per-lane material instances gathered from the scene's material table.

Role of ConstructMaterialInstance (src/shaders/common/Material.glsl:39-54):
roughness = max(G^2, 1e-4) (the stored G channel is sqrt of the TR-GGX
roughness), alpha^2 (`roughness2`) = roughness^2, reflectance F0 =
mix(0.04, albedo, metallic).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class MaterialInstance(NamedTuple):
    albedo: jnp.ndarray       # [N, 3]
    roughness: jnp.ndarray    # [N]  (= alpha)
    roughness2: jnp.ndarray   # [N]  (= alpha^2)
    metallic: jnp.ndarray     # [N]
    reflectance: jnp.ndarray  # [N, 3] F0
    emission: jnp.ndarray     # [N, 3]


def make_material_instance(scene, mat_id, uv=None,
                           textured: bool = False,
                           row=None, lod=None) -> MaterialInstance:
    """Gather material data for per-lane material ids [N].

    All constant fields come from ONE [N, 16] row gather of the packed
    mat_rows table (a gather costs per row, not per column); callers in
    the hot loop can pass a pre-gathered `row` to
    share it with their own field reads (e.g. the delta-material branch).

    With `textured` (static) and `uv`, albedo comes from the texture atlas
    for materials that have a map; constant albedo otherwise (the reference
    routes constants through 1x1 textures, Scene.cpp:100-104 — same value,
    no lookup needed, so untextured scenes compile without atlas gathers).
    """
    import jax.lax
    if row is None:
        row = scene.mat_rows[mat_id]          # [N, 16]
    albedo = row[:, 0:3]
    g = row[:, 3]
    metallic = row[:, 4]
    emission = row[:, 5:8]
    if textured and uv is not None:
        from gpupathtracer_tpu.ops.texture import sample_atlas
        # lod (traced [N], from the wavefront's ray-cone estimate) routes
        # both maps through the trilinear mip path; None = level 0 only.
        mips = scene.atlas_mips if lod is not None else None
        tex = jax.lax.bitcast_convert_type(row[:, 8], jnp.int32)
        albedo = jnp.where((tex >= 0)[:, None],
                           sample_atlas(scene.atlas_image, scene.atlas_rects,
                                        tex, uv, mips=mips, lod=lod), albedo)
        # Metallic-roughness map (glTF convention: G = roughness factor,
        # B = metallic factor; both multiply the material constants).
        mr = jax.lax.bitcast_convert_type(row[:, 9], jnp.int32)
        mr_rgb = sample_atlas(scene.atlas_image, scene.atlas_rects, mr, uv,
                              mips=mips, lod=lod)
        has_mr = mr >= 0
        g = jnp.where(has_mr, g * mr_rgb[:, 1], g)
        metallic = jnp.where(has_mr, metallic * mr_rgb[:, 2], metallic)
    roughness = jnp.maximum(g * g, 1e-4)
    reflectance = (0.04 * (1.0 - metallic[..., None])
                   + albedo * metallic[..., None])
    return MaterialInstance(
        albedo=albedo, roughness=roughness, roughness2=roughness * roughness,
        metallic=metallic, reflectance=reflectance, emission=emission)
