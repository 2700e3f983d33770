import math

import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.utils.io import save_png
import pytest

pytestmark = pytest.mark.slow  # render/traversal jits dominate; quick tier = -m 'not slow'


def test_cubemap_face_list(tmp_path):
    """Skybox mode 3: txt file listing 6 face images (Renderer.cpp:318,
    Texture.cpp:245-276 role)."""
    from gpupathtracer_tpu.scene.envmap import load_environment, sample_env
    colors = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1)]
    names = []
    for i, c in enumerate(colors):
        img = np.broadcast_to(np.asarray(c, np.float32), (8, 8, 3))
        name = f"face{i}.png"
        save_png(str(tmp_path / name), img.copy())
        names.append(name)
    (tmp_path / "sky.txt").write_text("\n".join(names) + "\n")
    env = load_environment(str(tmp_path / "sky.txt"))
    # GL face order: +X,-X,+Y,-Y,+Z,-Z. Sample axis directions.
    d = jnp.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                     [0, -1, 0], [0, 0, 1], [0, 0, -1]], jnp.float32)
    out = np.asarray(sample_env(env, d))
    for i, c in enumerate(colors):
        assert np.argmax(out[i]) == np.argmax(c), (i, out[i], c)


def test_degenerate_triangles_bvh():
    """Zero-area and coincident triangles must not break the builder or
    traversal (mechanizes the reference's invariant guards, SURVEY §4.3)."""
    from gpupathtracer_tpu.bvh import WideBVH, build_wide_bvh
    from gpupathtracer_tpu.bvh.wide import pack_for_packets
    from gpupathtracer_tpu.ops.intersect import pack_tri_geom
    from gpupathtracer_tpu.ops.traverse import trace_rows

    rng = np.random.RandomState(3)
    n = 64
    p0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    p1 = p0 + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    p2 = p0 + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    # degenerate: zero-area (all corners equal), coincident duplicates
    p1[:8] = p0[:8]
    p2[:8] = p0[:8]
    p0[8:16] = p0[0]
    p1[8:16] = p1[0]
    p2[8:16] = p2[0]
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=4)
    wide = pack_for_packets(wide, p0, p1 - p0, p2 - p0, 4)
    dev = WideBVH(*((jnp.asarray(a) if a is not None else None)
                    for a in wide))
    o = jnp.asarray(rng.uniform(-4, 4, (128, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(128, 3)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    t, prim, *_ = trace_rows(dev.node_rows, o, d,
                             jnp.full((128,), 1e20, jnp.float32),
                             jnp.ones((128,), bool), traversal="packet",
                             stack_depth=stats.max_depth * 7 + 2,
                             leaf_size=4)
    assert np.isfinite(np.asarray(t)[np.asarray(prim) >= 0]).all()
    # Zero-area triangles never get hit (strict MT inequalities).
    hit_prims = set(np.asarray(prim)[np.asarray(prim) >= 0].tolist())
    assert not (hit_prims & set(range(8)))


def test_empty_usemtl_obj(tmp_path):
    """OBJ with faces before any usemtl gets the default material."""
    from gpupathtracer_tpu.scene.objloader import load_obj
    (tmp_path / "d.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    mesh, mats = load_obj(str(tmp_path / "d.obj"))
    assert mesh.triangles.shape == (1, 3)
    assert mats[mesh.mat_ids[0]].name == "__default__"


def test_checkpoint_film_mismatch(tmp_path):
    """Resuming into a different film size fails loudly."""
    import pytest
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu.render import Renderer
    from gpupathtracer_tpu.render.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    cfg = RenderConfig(scene_path="proc:cornell",
                       skybox="GENERATE COLOR BLACK", width=16, height=16,
                       ray_chunk=256, max_bounces=2)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    r = Renderer(cfg)
    r.render_frame()
    p = save_checkpoint(r, str(tmp_path / "c.npz"))
    # Corrupt the stored film shape by rewriting the config inside.
    import numpy as np
    with np.load(p) as z:
        data = {k: z[k] for k in z.files}
    cfg2 = RenderConfig.from_json(bytes(data["config"]).decode())
    cfg2.width = 32
    data["config"] = np.frombuffer(cfg2.to_json().encode(), np.uint8)
    np.savez_compressed(p, **data)
    with pytest.raises(ValueError, match="checkpoint film"):
        load_checkpoint(p)


def test_spatial_split_duplication_budget():
    """Adversarial long thin diagonal triangles provoke spatial splits;
    the builder's duplication budget (sbvh.cpp extraRefBudget, ~30% of
    the triangle count — a guard the reference lacks, BVH.cpp:1927-1983
    duplicates unboundedly) must cap refs while keeping traversal exact."""
    from gpupathtracer_tpu.bvh.cpp import build_sbvh_cpp

    rng = np.random.RandomState(7)
    n = 400
    # Each triangle spans the whole [-5,5] diagonal with a tiny cross
    # section: worst case for axis-aligned bins, best case for clipping.
    a = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    b = -a + rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    c = a + rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    bvh, st = build_sbvh_cpp(a, b, c, max_leaf=4)
    assert st.num_refs >= n
    assert st.num_refs <= int(n * 1.35) + 8, \
        f"duplication budget breached: {st.num_refs} refs for {n} tris"
    # Every triangle still reachable.
    assert sorted(set(bvh.refs.tolist())) == list(range(n))
    # Traversal through the clipped tree matches brute force.
    from gpupathtracer_tpu.bvh.types import WideBVH
    from gpupathtracer_tpu.bvh.wide import collapse_to_wide
    from gpupathtracer_tpu.ops.intersect import (brute_force_closest_hit,
                                                 pack_tri_geom)
    from gpupathtracer_tpu.ops.traverse import closest_hit
    wide, depth = collapse_to_wide(bvh, arity=8)
    dev = WideBVH(child_bounds=jnp.asarray(wide.child_bounds),
                  child_entry=jnp.asarray(wide.child_entry),
                  refs=jnp.asarray(wide.refs))
    geom = jnp.asarray(pack_tri_geom(a, b - a, c - a))
    o = jnp.asarray(rng.uniform(-8, 8, (128, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(128, 3)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((128,), 1e20, jnp.float32)
    bt, bp, _, _ = brute_force_closest_hit(geom, o, d, tmax)
    h = closest_hit(dev, geom, o, d, tmax, stack_depth=depth * 7 + 2)
    np.testing.assert_allclose(np.asarray(h.t), np.asarray(bt),
                               rtol=1e-4, atol=1e-4)
