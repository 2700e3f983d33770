"""Exact-hit golden channel (VERDICT r3 weak #5 / next #6).

The HDR golden corpus (test_golden.py) uses float tolerances, which can
hide a single changed hit in a dark pixel. This channel is EXACT and
compiler-drift-immune: deterministic center-of-pixel primary rays
(fixed lens point, no jitter) traced through the default traversal, with
the winning PRIM ID compared by integer equality and bounce-0 t bitwise.
Any change to the hit set — a traversal reordering that resolves a tie
differently, a slab-test epsilon, a leaf packing bug — fails loudly on
the exact scene/camera the statistical goldens cover.

Mechanizes the role of the reference's P-key traversal-trail dump
(Renderer.cpp:664-678). Regenerate via tools/gen_goldens.py --hits after
a VERIFIED intentional traversal change.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# Same scenes as the HDR corpus (one per estimator surface).
HIT_CORPUS = {
    "cornell_hits_32": "proc:cornell",
    "table_hits_32": "proc:table",
    "bathroom_hits_32": "proc:bathroom",
}
RES = 32


def render_hits(name):
    """Deterministic primary-hit buffer: (prim [N] i32, t [N] f32)."""
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu.math.camera import gen_rays, generate_image_plane
    from gpupathtracer_tpu.ops.traverse import trace_closest
    from gpupathtracer_tpu.scene import load_scene

    scene_path = HIT_CORPUS[name]
    cfg = RenderConfig(scene_path=scene_path,
                       skybox="GENERATE COLOR BLACK",
                       width=RES, height=RES, cache_enabled=True)
    if scene_path == "proc:cornell":
        cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                                  fov=math.radians(45), aspect=1.0)
    else:
        from gpupathtracer_tpu.scene.procedural import default_camera
        pos, yaw, pitch, fov, aperture, focus = default_camera(scene_path)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=1.0,
                                  aperture=aperture, focal_distance=focus)
    scene, meta = load_scene(cfg)
    cam = generate_image_plane(cfg.camera)

    n = RES * RES
    idx = np.arange(n)
    px = (idx % RES).astype(np.float32)
    py = (idx // RES).astype(np.float32)
    interp = jnp.asarray(
        np.stack([(px + 0.5) / RES, (py + 0.5) / RES], axis=-1))
    lens_u = jnp.full((n, 2), 0.5, jnp.float32)  # fixed lens point (DoF)
    o, d = gen_rays(cam, interp, lens_u)
    tmax = jnp.full((n,), 1e20, jnp.float32)
    act = jnp.ones((n,), bool)
    hit = trace_closest(scene, o, d, tmax, act,
                        stack_depth=meta.stack_depth,
                        leaf_size=meta.leaf_size, traversal="auto",
                        packet_size=128)
    return (np.asarray(hit.prim, np.int32), np.asarray(hit.t, np.float32))


@pytest.mark.parametrize("name", sorted(HIT_CORPUS))
def test_exact_hit_golden(name):
    path = os.path.join(GOLDEN_DIR, name + ".npz")
    prim, t = render_hits(name)
    gold = np.load(path)
    # EXACT: one flipped hit anywhere fails.
    np.testing.assert_array_equal(prim, gold["prim"])
    # t bitwise for matching prims (same triangle, same MT arithmetic).
    np.testing.assert_array_equal(t, gold["t"])
    # Sanity: the buffer actually covers geometry.
    assert (prim >= 0).mean() > 0.5
