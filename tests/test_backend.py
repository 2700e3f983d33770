"""Backend dispatch, the CUDA traversal's Python wrapper and build, the
compile-cache rules and PNG I/O: the quick-tier checks of what surrounds
the GPU kernel, run on the CPU. The kernel itself is checked on a card by
the `gpu` tests here and by chip_smoke.py."""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.bvh.types import INVALID_ENTRY
from gpupathtracer_tpu.ops import cuda_traverse
from gpupathtracer_tpu.ops.traverse import (closest_hit, resolve_traversal,
                                            trace_closest, trace_occluded)


@pytest.fixture(scope="module")
def cornell():
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu.math.camera import generate_image_plane
    from gpupathtracer_tpu.ops.raysets import make_ray_sets
    from gpupathtracer_tpu.scene import load_scene
    cfg = RenderConfig(scene_path="proc:cornell",
                       skybox="GENERATE COLOR BLACK", width=24, height=16)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.5)
    scene, meta = load_scene(cfg)
    sets = make_ray_sets(scene, generate_image_plane(cfg.camera), 24, 16,
                         stack_depth=meta.stack_depth,
                         leaf_size=meta.leaf_size)
    return scene, meta, sets


@pytest.mark.parametrize("backend,want", [("cpu", "packet"),
                                          ("gpu", "cuda")])
def test_auto_traversal_by_backend(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolve_traversal("auto") == want
    assert resolve_traversal("perray") == "perray"


def test_cuda_traversal_refused_off_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(ValueError, match="GPU"):
        resolve_traversal("cuda")
    with pytest.raises(ValueError, match="unknown traversal"):
        resolve_traversal("pallas")


@pytest.mark.parametrize("failure", ["compiler_error", "no_nvcc"])
def test_failed_build_on_gpu_raises(monkeypatch, cornell, failure):
    """A GPU run whose library cannot be built stops with the build's
    error; it never falls back to an XLA traversal."""
    scene, meta, sets = cornell
    o, d, tm, act = sets["primary"]
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cuda_traverse, "_registered", False)
    if failure == "compiler_error":
        monkeypatch.setattr(cuda_traverse, "_nvcc", lambda: "false")
        match = "building the CUDA traversal failed"
    else:
        monkeypatch.setattr(cuda_traverse.shutil, "which", lambda _: None)
        monkeypatch.setattr(cuda_traverse.os.path, "exists",
                            lambda p: False)
        match = "nvcc not found"
    with pytest.raises(RuntimeError, match=match):
        trace_closest(scene, o, d, tm, act, stack_depth=meta.stack_depth,
                      leaf_size=meta.leaf_size)


@pytest.mark.parametrize("root", [None, 5, "per_ray"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_wrapper_packs_rays_and_unpacks_hits(monkeypatch, root,
                                                  any_hit):
    """The call is stubbed: check the [N, 8] ray rows (root broadcast,
    inactive lanes as INVALID_ENTRY), the attributes passed, and the
    unpacked [N] outputs."""
    n = 37
    rng = np.random.RandomState(0)
    o = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    tm = jnp.asarray(rng.uniform(1, 9, n), jnp.float32)
    act = jnp.asarray(np.arange(n) % 4 != 1)
    roots = (jnp.arange(n, dtype=jnp.int32) if root == "per_ray" else root)
    rows = jnp.zeros((3, 128), jnp.float32)
    seen = {}

    def fake_call(rows_, rays, *, stack_depth, any_hit):
        seen.update(rays=rays, stack_depth=stack_depth, any_hit=any_hit)
        prim = jnp.arange(rays.shape[0], dtype=jnp.int32) - 3
        hits = jnp.stack([rays[:, 3] * 0.5, rays[:, 0], rays[:, 1],
                          jax.lax.bitcast_convert_type(prim, jnp.float32)],
                         axis=1)
        return hits, jnp.full((rays.shape[0],), 7, jnp.int32)

    monkeypatch.setattr(cuda_traverse, "register", lambda: None)
    monkeypatch.setattr(cuda_traverse, "_ffi_traverse", fake_call)
    t, prim, u, v, pops = cuda_traverse.traverse_rows_cuda(
        rows, o, d, tm, act, stack_depth=40, any_hit=any_hit, root=roots)

    rays = np.asarray(seen["rays"])
    assert rays.shape == (n, 8) and rays.dtype == np.float32
    np.testing.assert_array_equal(rays[:, 0:3], np.asarray(o))
    np.testing.assert_array_equal(rays[:, 3], np.asarray(tm))
    np.testing.assert_array_equal(rays[:, 4:7], np.asarray(d))
    entry = rays[:, 7].view(np.int32)
    want = np.broadcast_to(np.asarray(0 if root is None else roots), (n,))
    np.testing.assert_array_equal(entry, np.where(np.asarray(act), want,
                                                  INVALID_ENTRY))
    assert seen["stack_depth"] == 40 and seen["any_hit"] == any_hit
    for a in (t, prim, u, v, pops):
        assert a.shape == (n,)
    np.testing.assert_array_equal(np.asarray(prim), np.arange(n) - 3)
    np.testing.assert_allclose(np.asarray(t), np.asarray(tm) * 0.5)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(o)[:, 0])


def test_cuda_wrapper_rejects_stack_depth():
    z = jnp.zeros((4, 3), jnp.float32)
    with pytest.raises(ValueError, match="stack_depth"):
        cuda_traverse.traverse_rows_cuda(
            jnp.zeros((1, 128)), z, z, jnp.ones(4), jnp.ones(4, bool),
            stack_depth=cuda_traverse.MAX_STACK_DEPTH + 1, any_hit=False)


@pytest.mark.parametrize("set_name", ["primary", "bounce", "shadow"])
def test_packet_matches_perlane_on_cornell(cornell, set_name):
    from gpupathtracer_tpu.ops.raysets import (compare_hits,
                                               compare_occlusion)
    scene, meta, sets = cornell
    o, d, tm, act = sets[set_name]
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    ref = closest_hit(scene.bvh, scene.tri_geom, o, d, tm, act, **kw)
    if set_name == "shadow":
        occ = trace_occluded(scene, o, d, tm, act, traversal="packet", **kw)
        assert compare_occlusion(ref.t, tm, occ, act)["occlusion"] == 0
    else:
        hit = trace_closest(scene, o, d, tm, act, traversal="packet", **kw)
        c = compare_hits(ref.t, ref.prim, hit.t, hit.prim, act)
        assert c["hit_miss"] == c["t"] == c["prim"] == 0, c


@pytest.mark.gpu
@pytest.mark.parametrize("set_name", ["primary", "bounce", "shadow"])
def test_cuda_matches_perlane_on_card(gpu_backend, cornell, set_name):
    from gpupathtracer_tpu.ops.raysets import (compare_hits,
                                               compare_occlusion)
    scene, meta, sets = cornell
    o, d, tm, act = sets[set_name]
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    ref = closest_hit(scene.bvh, scene.tri_geom, o, d, tm, act, **kw)
    if set_name == "shadow":
        occ = trace_occluded(scene, o, d, tm, act, traversal="cuda", **kw)
        assert compare_occlusion(ref.t, tm, occ, act)["share"] <= 1e-4
    else:
        hit = trace_closest(scene, o, d, tm, act, traversal="cuda", **kw)
        assert compare_hits(ref.t, ref.prim, hit.t, hit.prim,
                            act)["share"] <= 1e-4


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    from gpupathtracer_tpu.utils import compile_cache, paths
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in updates
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(paths.CHECKOUT_DIR, "cache", "xla")
        assert updates["jax_compilation_cache_dir"] == path
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 0


def test_png_round_trip_without_pillow(monkeypatch, tmp_path):
    from gpupathtracer_tpu.utils.io import load_image, save_png
    monkeypatch.setitem(sys.modules, "PIL", None)  # any Pillow import fails
    img = np.random.RandomState(1).randint(0, 256, (13, 21, 3)).astype(
        np.uint8)
    path = save_png(str(tmp_path / "x.png"), img)
    back = load_image(path)
    assert back.shape == (13, 21, 3) and back.dtype == np.float32
    np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8), img)
    flipped = load_image(save_png(str(tmp_path / "y.png"), img, flip_y=True))
    np.testing.assert_array_equal(
        np.round(flipped * 255).astype(np.uint8), img[::-1])
    with pytest.raises(ImportError, match="Pillow"):
        load_image(str(tmp_path / "tex.jpg"))
