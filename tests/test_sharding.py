"""Multi-device sharding tests on the 8-device CPU mesh."""

import math

import jax
import numpy as np
import pytest

from gpupathtracer_tpu.config import CameraConfig, RenderConfig
from gpupathtracer_tpu.math.camera import generate_image_plane
from gpupathtracer_tpu.parallel import make_device_mesh, render_sample_sharded
from gpupathtracer_tpu.scene import load_scene

pytestmark = pytest.mark.slow  # render/traversal jits dominate; quick tier = -m 'not slow'


@pytest.fixture(scope="module")
def cornell():
    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=32, height=32)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    scene, meta = load_scene(cfg)
    return cfg, scene, meta


def _pixels(n_side=32):
    import numpy as np
    idx = np.arange(n_side * n_side)
    px = (idx % n_side).astype(np.float32)
    py = (idx // n_side).astype(np.float32)
    return jax.numpy.asarray(px), jax.numpy.asarray(py)


def _static(cfg, meta):
    return dict(width=32, height=32, max_bounces=8,
                stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
                model=cfg.microfacet, nee=True)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (8, 1)])
def test_sharded_render_shapes(cornell, shape):
    cfg, scene, meta = cornell
    mesh = make_device_mesh(shape)
    cam = generate_image_plane(cfg.camera)
    px, py = _pixels()
    key = jax.random.PRNGKey(0)
    out, rays = render_sample_sharded(mesh, scene, cam, px, py, key,
                                      **_static(cfg, meta))
    out = np.asarray(out)
    assert out.shape == (32 * 32, 3)
    assert np.isfinite(out).all()
    assert int(rays) > 32 * 32  # at least one secondary ray somewhere
    # Sample axis accumulates: brightness scales with the axis size.
    s = shape[0]
    assert out.sum() > 0


def test_sample_axis_accumulates(cornell):
    """An (8,1) mesh frame = 8 samples; mean matches 8x a single-device
    render statistically."""
    cfg, scene, meta = cornell
    cam = generate_image_plane(cfg.camera)
    px, py = _pixels()
    key = jax.random.PRNGKey(3)
    mesh8 = make_device_mesh((8, 1))
    out8, _ = render_sample_sharded(mesh8, scene, cam, px, py, key,
                                    **_static(cfg, meta))
    mean8 = float(np.asarray(out8).mean()) / 8.0

    from gpupathtracer_tpu.models.wavefront import render_sample
    acc = 0.0
    for s in range(8):
        k = jax.random.fold_in(jax.random.PRNGKey(17), s)
        c, _ = render_sample(scene, cam, px, py, k, **_static(cfg, meta))
        acc += float(np.asarray(c).mean())
    mean1 = acc / 8.0
    assert abs(mean8 - mean1) / (mean1 + 1e-9) < 0.15, (mean8, mean1)


def test_pixel_shards_cover_film(cornell):
    """Pixel sharding returns each lane's own pixel: a sharded render and an
    unsharded render with per-shard keys must agree lane-for-lane."""
    cfg, scene, meta = cornell
    cam = generate_image_plane(cfg.camera)
    px, py = _pixels()
    key = jax.random.PRNGKey(5)
    mesh = make_device_mesh((1, 8))
    out, _ = render_sample_sharded(mesh, scene, cam, px, py, key,
                                   **_static(cfg, meta))
    out = np.asarray(out)

    from gpupathtracer_tpu.models.wavefront import render_sample
    n = px.shape[0]
    shard = n // 8
    ref = np.zeros((n, 3), np.float32)
    for i in range(8):
        k = jax.random.fold_in(jax.random.fold_in(key, 0), i + 1311)
        sl = slice(i * shard, (i + 1) * shard)
        c, _ = render_sample(scene, cam, px[sl], py[sl], k,
                             **_static(cfg, meta))
        ref[sl] = np.asarray(c)
    # Sharded and unsharded compiles may reassociate floats slightly.
    np.testing.assert_allclose(out, ref, rtol=3e-4, atol=1e-5)


def test_renderer_mesh_integration():
    """Renderer drives the sharded path when cfg.mesh_shape > (1,): one
    frame accumulates samples_per_frame spp, statistically matching the
    single-device renderer."""
    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=16, height=16, ray_chunk=256, max_bounces=8,
                       mesh_shape=(4, 2))
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    from gpupathtracer_tpu.render import Renderer
    r = Renderer(cfg)
    assert r.samples_per_frame == 4
    for _ in range(3):
        r.render_frame()
    assert r.num_samples == 12
    img = r.film_hdr()
    assert np.isfinite(img).all()

    cfg1 = RenderConfig(scene_path="proc:cornell",
                        skybox="GENERATE COLOR BLACK", width=16, height=16,
                        ray_chunk=256, max_bounces=8)
    cfg1.camera = cfg.camera
    r1 = Renderer(cfg1, scene=r.scene, meta=r.meta)
    for _ in range(12):
        r1.render_frame()
    m, m1 = img.mean(), r1.film_hdr().mean()
    assert abs(m - m1) / (m1 + 1e-9) < 0.2, (m, m1)


def test_sharded_gltf_pipeline(tmp_path):
    """Config-5 role (BASELINE.md): a glTF scene through the FULL sharded
    renderer on a (2, 4) mesh — loader, materials, emitter CDF, wavefront,
    psum accumulation."""
    from gpupathtracer_tpu.render import Renderer
    from gpupathtracer_tpu.scene.samplegen import write_demo_gltf

    path = write_demo_gltf(str(tmp_path / "demo.gltf"))
    cfg = RenderConfig(scene_path=path, skybox="GENERATE COLOR BLACK",
                       width=32, height=24, ray_chunk=32 * 24, max_bounces=6,
                       mesh_shape=(2, 4), cache_enabled=False)
    cfg.camera = CameraConfig(position=(0.0, 2.0, -6.0), yaw=math.pi,
                              pitch=-0.15, fov=math.radians(50),
                              aspect=32 / 24)
    r = Renderer(cfg)
    r.render_frame()
    assert r.num_samples == 2  # samples axis = 2 spp per sharded frame
    img = r.film_hdr()
    assert np.isfinite(img).all()
    assert img.mean() > 0  # lamp-lit


def test_sharded_checkpoint_resume_bitwise(tmp_path):
    """Checkpoint/resume of a SHARDED render is bitwise-identical to the
    uninterrupted sharded run (threefry keys derive from num_samples, which
    the checkpoint restores)."""
    from gpupathtracer_tpu.render import Renderer
    from gpupathtracer_tpu.render.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    def mk():
        cfg = RenderConfig(scene_path="proc:cornell",
                           skybox="GENERATE COLOR BLACK",
                           width=16, height=16, ray_chunk=256, max_bounces=4,
                           mesh_shape=(2, 4))
        cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                                  fov=math.radians(45), aspect=1.0)
        return cfg

    r1 = Renderer(mk())
    for _ in range(4):
        r1.render_frame()
    full = np.asarray(r1.accum).copy()

    r2 = Renderer(mk(), scene=r1.scene, meta=r1.meta)
    for _ in range(2):
        r2.render_frame()
    ckpt = save_checkpoint(r2, str(tmp_path / "sharded.ckpt.npz"))
    r3 = load_checkpoint(ckpt)
    assert r3.mesh is not None and r3.samples_per_frame == 2
    for _ in range(2):
        r3.render_frame()
    assert r3.num_samples == r1.num_samples
    np.testing.assert_array_equal(np.asarray(r3.accum), full)


def test_pixels_axis_radiance_stays_local(cornell):
    """Multi-host contract: mapping the mesh's "pixels" axis to the
    cross-host dimension must move NO radiance across it — each host accumulates its own film tile locally and the
    only pixels-axis collective is the scalar ray counter (8 bytes per
    frame). The samples axis (the psum of radiance) then stays within
    a host. Pinned at the compiled-HLO level so a refactor cannot
    silently introduce a cross-host all-reduce of the film."""
    import re

    cfg, scene, meta = cornell
    mesh = make_device_mesh((8,))  # pixels-only mesh = the DCN axis alone
    cam = generate_image_plane(cfg.camera)
    px, py = _pixels()
    key = jax.random.PRNGKey(0)

    def fn(s, c, x, y, k):
        return render_sample_sharded(mesh, s, c, x, y, k,
                                     **_static(cfg, meta))

    txt = jax.jit(fn).lower(scene, cam, px, py, key).compile().as_text()
    coll = [ln for ln in txt.splitlines()
            if re.search(r"all-reduce|all-gather|collective-permute"
                         r"|all-to-all|reduce-scatter", ln)]
    assert coll, "expected the scalar ray-counter psum to remain"
    for ln in coll:
        # Every collective must be the scalar counter — never the film.
        assert re.search(r"\b[su]32\[\]", ln), f"non-scalar collective: {ln}"


def test_film_padding_non_dividing_pixels_axis():
    """A film whose ray count doesn't divide the pixels axis pads with
    sentinel rays; the padded output drops them (was: ValueError)."""
    from gpupathtracer_tpu.render import Renderer

    cfg = RenderConfig(scene_path="proc:cornell",
                       skybox="GENERATE COLOR BLACK",
                       width=16, height=16, ray_chunk=1 << 10, max_bounces=4,
                       mesh_shape=(1, 3))  # 256 rays % 3 != 0
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    r = Renderer(cfg)
    assert r.n_rays % 3 == 0 and r.n_rays > 256
    r.render_frame()
    img = r.film_hdr()
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()

    # The sentinel rays (fwd == n) trace pixel (0, 0) and must land in the
    # dropped +1 film slot, never a real pixel. Deterministic guard: the
    # sentinel lanes did accumulate radiance (they trace a lit pixel), yet
    # poisoning them leaves every film pixel bit-identical — so no sentinel
    # contribution can reach the film, not even a small one.
    ray_to_pixel = np.asarray(r._ray_to_pixel)
    n_px = r.pad_w * r.pad_h
    sentinel = np.nonzero(ray_to_pixel == n_px)[0]
    assert len(sentinel) == r.n_rays - n_px > 0
    accum = np.asarray(r.accum)
    assert np.abs(accum[sentinel]).sum() > 0, \
        "sentinel rays traced a lit pixel but accumulated nothing"
    import jax.numpy as jnp
    r.accum = r.accum.at[jnp.asarray(sentinel)].set(1e6)
    np.testing.assert_array_equal(r.film_hdr(), img)

    # And the padded sharded render still agrees statistically with the
    # unsharded render of the same scene (different RNG lane mapping).
    cfg2 = RenderConfig(scene_path="proc:cornell",
                        skybox="GENERATE COLOR BLACK",
                        width=16, height=16, ray_chunk=1 << 10, max_bounces=4)
    cfg2.camera = cfg.camera
    r2 = Renderer(cfg2, scene=r.scene, meta=r.meta)
    r2.render_frame()
    img2 = r2.film_hdr()
    assert abs(img.mean() - img2.mean()) / max(img2.mean(), 1e-6) < 0.5
