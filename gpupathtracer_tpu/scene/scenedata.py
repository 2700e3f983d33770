"""Device scene representation and the full ingest pipeline.

Role of Scene::LoadScene (src/core/Scene.cpp:233-357): load geometry, build
the SBVH, build the emitter CDF, pack material/triangle/light arrays, upload.
Here "upload" = jnp device arrays in a pytree; the scene is replicated per
device and the ray/sample space is what gets sharded (SURVEY.md §2.5).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.bvh import BuildStats, WideBVH, build_wide_bvh
from gpupathtracer_tpu.config import RenderConfig
from gpupathtracer_tpu.ops.intersect import pack_tri_geom
from gpupathtracer_tpu.scene.envmap import EnvMap, load_environment
from gpupathtracer_tpu.scene.materials import MaterialDesc, pack_materials
from gpupathtracer_tpu.scene.mesh import MeshData, TriangleSoup, build_triangle_soup


class SceneData(NamedTuple):
    """Everything the integrator needs, as device arrays (a pytree)."""

    # Geometry
    tri_geom: jnp.ndarray      # [T, 9] (p0, e1, e2) MT-packed
    tri_normal: jnp.ndarray    # [T, 3] geometric normal
    tri_uv: jnp.ndarray        # [T, 3, 2]
    tri_mat: jnp.ndarray       # [T] i32
    # Packed per-triangle shading row: ONE [T, 16] gather per bounce where
    # the integrator used three (normal / uv / mat id): a gather costs per
    # ROW, not per column. Cols 0:3 normal, 3:9 uv (3 x 2), 9 mat-id
    # bits (i32 bit-cast), rest pad.
    tri_shade: jnp.ndarray     # [T, 32] f32 (shade cols 0:16, mat row 16:32)
    # Packed per-material row (same one-gather rationale): 0:3 albedo,
    # 3 rough_g, 4 metallic, 5:8 emission, 8 albedo-tex bits, 9 mr-tex
    # bits, 10 type bits, 11 ior, rest pad.
    mat_rows: jnp.ndarray      # [M, 16] f32
    # Packed per-emitter row: 0:3 p0, 3:6 e1, 6:9 e2, 9:12 normal,
    # 12:15 emission, 15 pad (the CDF search stays on light_cdf).
    light_rows: jnp.ndarray    # [L, 16] f32
    # Materials
    mat_albedo: jnp.ndarray    # [M, 3]
    mat_rough_g: jnp.ndarray   # [M]
    mat_metallic: jnp.ndarray  # [M]
    mat_emission: jnp.ndarray  # [M, 3]
    mat_type: jnp.ndarray      # [M] i32 MATERIAL_* enum (mirror/refractive)
    mat_ior: jnp.ndarray       # [M] f32 index of refraction
    # Emitters (cumulative-area CDF, Scene.cpp:296-331)
    light_cdf: jnp.ndarray     # [L] cumulative areas (ascending)
    light_tri: jnp.ndarray     # [L] triangle index
    total_light_area: jnp.ndarray  # scalar f32 (0 => env-only lighting)
    # Texture atlas (role of bindless textures, Material.glsl:43-44)
    atlas_image: jnp.ndarray   # [AH, AW, 3] f32
    atlas_rects: jnp.ndarray   # [R, 4] i32 (x, y, w, h; R >= S with mips)
    atlas_mips: jnp.ndarray    # [S, L] i32 texture-slot -> rect row per
    #                            mip level (L=1 without cfg.mip_levels)
    mat_albedo_tex: jnp.ndarray  # [M] i32 atlas slot, -1 = constant albedo
    mat_mr_tex: jnp.ndarray      # [M] i32 metallic-roughness slot (glTF G=rough, B=metal)
    # Sun disk (Renderer.cpp:23-26; SUN_LIGHT NEE branch Iterative.comp:84-126)
    sun_dir: jnp.ndarray       # [3] unit, pointing *from* scene *to* sun
    sun_emission: jnp.ndarray  # [3]
    sun_radius: jnp.ndarray    # scalar: tan(angular radius)
    sun_max_dot: jnp.ndarray   # scalar: cos(angular radius)
    # Environment
    env: EnvMap
    # Acceleration structure
    bvh: WideBVH               # jnp arrays


@dataclass
class SceneMeta:
    """Static (non-traced) facts about a loaded scene."""

    num_triangles: int
    num_materials: int
    num_lights: int
    stack_depth: int           # traversal stack bound from the wide depth
    leaf_size: int
    has_textures: bool = False
    has_delta: bool = False    # any mirror/refractive materials
    mip_levels: int = 1        # atlas pyramid depth (1 = level 0 only)
    bvh_stats: Optional[BuildStats] = None
    name: str = ""


def build_emitter_cdf(soup: TriangleSoup, emissive_mask: np.ndarray):
    """Emitter CDF (Scene.cpp:296-331): Heron area per emissive triangle,
    sorted ascending, cumulative sum."""
    p0, p1, p2 = soup.vertices()
    emissive_tri = emissive_mask[soup.mat]
    idx = np.nonzero(emissive_tri)[0].astype(np.int32)
    if idx.size:
        a = np.linalg.norm(p0[idx] - p2[idx], axis=1)
        b = np.linalg.norm(p0[idx] - p1[idx], axis=1)
        c = np.linalg.norm(p2[idx] - p1[idx], axis=1)
        s = (a + b + c) / 2
        area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))
        order = np.argsort(area, kind="stable")
        idx = idx[order]
        cdf = np.cumsum(area[order]).astype(np.float32)
        total_area = float(cdf[-1])
    else:  # pad so gathers stay valid; inf pdf zeroes NEE (see integrator)
        idx = np.zeros(1, np.int32)
        cdf = np.zeros(1, np.float32)
        total_area = 0.0
    return idx, cdf, total_area


def pack_scene(soup: TriangleSoup, materials: List[MaterialDesc],
               env: EnvMap, cfg: Optional[RenderConfig] = None,
               name: str = "") -> Tuple[SceneData, SceneMeta]:
    """Pack a triangle soup + materials + env into device arrays and build
    the BVH. This is the one funnel every loader goes through."""
    cfg = cfg or RenderConfig()
    atlas_img, atlas_rects, slots, atlas_mips = _build_atlas_for(
        materials, ".", cfg)
    table = pack_materials(materials, atlas_slots=slots)
    idx, cdf, total_area = build_emitter_cdf(soup, table.emissive)
    p0, p1, p2 = soup.vertices()
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=cfg.leaf_size,
                                 arity=cfg.wide_arity, builder=cfg.bvh_builder,
                                 spatial_splits=cfg.spatial_splits,
                                 force_leaf=cfg.force_leaf,
                                 reinsert_rounds=cfg.reinsert_rounds)
    return _upload(soup, table, idx, cdf, total_area, wide, stats, env,
                   cfg, name, atlas_img, atlas_rects, atlas_mips)


def _build_atlas_for(materials, base_dir, cfg):
    from gpupathtracer_tpu.scene.textures import build_atlas
    paths = sorted({m.albedo_texture for m in materials if m.albedo_texture}
                   | {m.mr_texture for m in materials if m.mr_texture})
    return build_atlas(paths, base_dir,
                       mip_levels=getattr(cfg, "mip_levels", 1))


def _upload(soup, table, idx, cdf, total_area, wide, stats, env, cfg,
            name: str, atlas_img=None, atlas_rects=None, atlas_mips=None
            ) -> Tuple[SceneData, SceneMeta]:
    if atlas_img is None:
        atlas_img = np.zeros((4, 4, 3), np.float32)
        atlas_rects = np.asarray([[0, 0, 4, 4]], np.int32)
    if atlas_mips is None:  # level-0 identity (old caches / no-mip builds)
        atlas_mips = np.arange(atlas_rects.shape[0],
                               dtype=np.int32)[:, None]
    stack_depth = min(max(stats.max_depth * (cfg.wide_arity - 1) + 2, 8),
                      cfg.stack_depth * 4)
    if wide.node_rows is None:
        from gpupathtracer_tpu.bvh.wide import pack_for_packets
        wide = pack_for_packets(wide, soup.p0, soup.e1, soup.e2,
                                leaf_size=cfg.leaf_size)

    M = int(table.albedo.shape[0])
    mrows = np.zeros((max(M, 1), 16), np.float32)
    if M:
        mrows[:, 0:3] = table.albedo
        mrows[:, 3] = table.rough_g
        mrows[:, 4] = table.metallic
        mrows[:, 5:8] = table.emission
        mrows[:, 8] = np.asarray(table.albedo_tex,
                                 np.int32).view(np.float32)
        mr_tex = (table.mr_tex if table.mr_tex is not None
                  else np.full_like(table.albedo_tex, -1))
        mrows[:, 9] = np.asarray(mr_tex, np.int32).view(np.float32)
        mrows[:, 10] = np.asarray(table.mtype, np.int32).view(np.float32)
        mrows[:, 11] = table.ior

    # Per-triangle shading row with the triangle's MATERIAL row pre-joined
    # (cols 16:32 = mat_rows[tri.mat]): the wavefront hot loop then pays ONE
    # [N, 32] row gather per bounce instead of tri_shade[prim] followed by
    # mat_rows[mat_id], so the join removes a full gather per lane-bounce.
    T = soup.num_triangles
    shade = np.zeros((max(T, 1), 32), np.float32)
    if T:
        shade[:, 0:3] = soup.normal
        shade[:, 3:9] = soup.uv.reshape(T, 6)
        shade[:, 9] = soup.mat.astype(np.int32).view(np.float32)
        # Col 10: texel density sqrt(uv_area / world_area) — the mip-LOD
        # input (uv units per world unit; ops/texture.py trilinear path).
        # Free column, so the mip path adds NO extra hot-loop gather.
        e1 = soup.e1
        e2 = soup.e2
        wa = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        duv1 = soup.uv[:, 1] - soup.uv[:, 0]
        duv2 = soup.uv[:, 2] - soup.uv[:, 0]
        ua = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1]
                          - duv1[:, 1] * duv2[:, 0])
        shade[:, 10] = np.sqrt(ua / np.maximum(wa, 1e-20))
        shade[:, 16:32] = mrows[soup.mat]

    L = int(idx.size)
    lrows = np.zeros((max(L, 1), 16), np.float32)
    if L:
        lgeom = pack_tri_geom(soup.p0, soup.e1, soup.e2)[idx]
        lrows[:, 0:9] = lgeom
        lrows[:, 9:12] = soup.normal[idx]
        lrows[:, 12:15] = table.emission[soup.mat[idx]]

    data = SceneData(
        tri_geom=jnp.asarray(pack_tri_geom(soup.p0, soup.e1, soup.e2)),
        tri_normal=jnp.asarray(soup.normal),
        tri_uv=jnp.asarray(soup.uv),
        tri_mat=jnp.asarray(soup.mat),
        tri_shade=jnp.asarray(shade),
        mat_rows=jnp.asarray(mrows),
        light_rows=jnp.asarray(lrows),
        mat_albedo=jnp.asarray(table.albedo),
        mat_rough_g=jnp.asarray(table.rough_g),
        mat_metallic=jnp.asarray(table.metallic),
        mat_emission=jnp.asarray(table.emission),
        mat_type=jnp.asarray(table.mtype),
        mat_ior=jnp.asarray(table.ior),
        light_cdf=jnp.asarray(cdf),
        light_tri=jnp.asarray(idx),
        total_light_area=jnp.float32(total_area),
        atlas_image=jnp.asarray(atlas_img),
        atlas_rects=jnp.asarray(atlas_rects),
        atlas_mips=jnp.asarray(atlas_mips),
        mat_albedo_tex=jnp.asarray(table.albedo_tex),
        mat_mr_tex=jnp.asarray(table.mr_tex if table.mr_tex is not None
                               else np.full_like(table.albedo_tex, -1)),
        sun_dir=jnp.asarray(np.asarray(cfg.sun_direction, np.float32)
                            / max(np.linalg.norm(cfg.sun_direction), 1e-9)),
        sun_emission=jnp.asarray(np.asarray(cfg.sun_emission, np.float32)),
        sun_radius=jnp.float32(np.tan(cfg.sun_angle)),
        sun_max_dot=jnp.float32(np.cos(cfg.sun_angle)),
        env=env,
        bvh=WideBVH(child_bounds=jnp.asarray(wide.child_bounds),
                    child_entry=jnp.asarray(wide.child_entry),
                    refs=jnp.asarray(wide.refs),
                    node_rows=jnp.asarray(wide.node_rows),
                    packet_entry=jnp.asarray(wide.packet_entry)),
    )
    meta = SceneMeta(
        num_triangles=soup.num_triangles,
        num_materials=int(table.albedo.shape[0]),
        num_lights=int(idx.size if total_area > 0 else 0),
        stack_depth=stack_depth,
        leaf_size=cfg.leaf_size,
        has_textures=bool((table.albedo_tex >= 0).any()
                          or (table.mr_tex is not None
                              and (table.mr_tex >= 0).any())),
        has_delta=bool((table.mtype != 1).any()),
        mip_levels=int(atlas_mips.shape[1]),
        bvh_stats=stats,
        name=name,
    )
    return data, meta


def load_scene(cfg: RenderConfig) -> Tuple[SceneData, SceneMeta]:
    """Full ingest: dispatch on scene_path, load env, pack, build BVH.

    Supports "proc:<name>" procedural scenes, .obj, and .gltf/.glb. The
    packed scene + BVH is disk-cached (role of the reference's decoded-image
    cache, Texture.cpp:35-88) because SBVH build dominates startup.
    """
    path = cfg.scene_path
    base_dir = os.path.dirname(os.path.abspath(path)) if os.path.sep in path else "."
    env = load_environment(cfg.skybox, base_dir=base_dir)

    from gpupathtracer_tpu.scene import cache as scache
    from gpupathtracer_tpu.scene.materials import MaterialTable
    from gpupathtracer_tpu.bvh.types import WideBVH as _Wide
    cached = scache.load_scene_cache(cfg)
    if cached is not None:
        soup = TriangleSoup(p0=cached["p0"], e1=cached["e1"], e2=cached["e2"],
                            normal=cached["normal"], uv=cached["uv"],
                            mat=cached["mat"])
        table = MaterialTable(albedo=cached["m_albedo"],
                              rough_g=cached["m_rough"],
                              metallic=cached["m_metal"],
                              emission=cached["m_emission"],
                              emissive=cached["m_emissive"],
                              albedo_tex=cached["m_tex"],
                              mtype=cached["m_type"],
                              ior=cached["m_ior"],
                              mr_tex=cached.get("m_mr_tex"))
        wide = _Wide(child_bounds=cached["child_bounds"],
                     child_entry=cached["child_entry"], refs=cached["refs"])
        st = cached["stats"]
        stats = BuildStats(num_triangles=int(st[0]), num_refs=int(st[1]),
                           num_binary_nodes=int(st[2]),
                           num_wide_nodes=int(st[3]), num_leaves=int(st[4]),
                           max_depth=int(st[5]), spatial_splits=int(st[6]),
                           sah_cost=float(cached["sah"]))
        return _upload(soup, table, cached["light_idx"], cached["light_cdf"],
                       float(cached["total_area"]), wide, stats, env, cfg,
                       name=path, atlas_img=cached.get("atlas_img"),
                       atlas_rects=cached.get("atlas_rects"),
                       atlas_mips=cached.get("atlas_mips"))

    if path.startswith("proc:"):
        from gpupathtracer_tpu.scene.procedural import load_procedural
        mesh, materials = load_procedural(path)
    elif path.lower().endswith(".obj"):
        from gpupathtracer_tpu.scene.objloader import load_obj
        mesh, materials = load_obj(path)
    elif path.lower().endswith((".gltf", ".glb")):
        from gpupathtracer_tpu.scene.gltf import load_gltf
        mesh, materials = load_gltf(path)
    else:
        raise ValueError(f"unsupported scene format: {path!r}")

    soup = build_triangle_soup(mesh)
    atlas_img, atlas_rects, slots, atlas_mips = _build_atlas_for(
        materials, base_dir, cfg)
    table = pack_materials(materials, atlas_slots=slots)
    idx, cdf, total_area = build_emitter_cdf(soup, table.emissive)
    p0, p1, p2 = soup.vertices()
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=cfg.leaf_size,
                                 arity=cfg.wide_arity, builder=cfg.bvh_builder,
                                 spatial_splits=cfg.spatial_splits,
                                 force_leaf=cfg.force_leaf,
                                 reinsert_rounds=cfg.reinsert_rounds)
    if cfg.cache_enabled:
        scache.save_scene_cache(cfg, soup, table, idx, cdf, total_area,
                                wide, stats, atlas_img, atlas_rects,
                                atlas_mips)
    return _upload(soup, table, idx, cdf, total_area, wide, stats, env, cfg,
                   name=path, atlas_img=atlas_img, atlas_rects=atlas_rects,
                   atlas_mips=atlas_mips)
