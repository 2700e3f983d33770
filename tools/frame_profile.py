#!/usr/bin/env python
"""Headline-frame cost bisection.

Renders the bench config with estimator stages toggled off to attribute
frame time, on the GPU. Each frame is ended by block_until_ready; each
variant is the median of 3 runs of 3 frames. Extend VARIANTS as needed.

Usage: python tools/frame_profile.py [full,nonee,...] [--scene proc:sponza]
"""
import argparse
import sys, math, time, statistics
sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))
import jax, jax.numpy as jnp, numpy as np
from gpupathtracer_tpu.config import CameraConfig, RenderConfig
from gpupathtracer_tpu.render import Renderer
from gpupathtracer_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()

_ap = argparse.ArgumentParser()
_ap.add_argument("variants", nargs="?", default="full,nonee")
_ap.add_argument("--scene", default="proc:sponza")
_ap.add_argument("--width", type=int, default=1920)
_ap.add_argument("--height", type=int, default=1080)
_ap.add_argument("--microfacet", default="trowbridge_reitz")
_ARGS = _ap.parse_args()

def frame(label, **kw):
    w, h = _ARGS.width, _ARGS.height
    kw.setdefault("max_bounces", 64)
    cfg = RenderConfig(scene_path=_ARGS.scene, skybox="GENERATE COLOR BLACK",
                       width=w, height=h, integrator="wavefront",
                       microfacet=_ARGS.microfacet,
                       ray_chunk=1 << 21, cache_enabled=True,
                       **kw)
    if _ARGS.scene == "proc:sponza":
        cfg.camera = CameraConfig(position=(-18.0, 4.5, 0.0), yaw=math.pi/2,
                                  pitch=-0.05, fov=math.radians(60),
                                  aspect=w/h)
    else:
        from gpupathtracer_tpu.scene.procedural import default_camera
        pos, yaw, pitch, fov, aperture, focus = default_camera(_ARGS.scene)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=w/h,
                                  aperture=aperture, focal_distance=focus)
    r = Renderer(cfg)
    r.render_frame(sync=True)
    batch = kw.get("frame_batch", 1)  # report per-spp when batched
    meds = []
    for _ in range(3):
        t0 = time.time()
        for i in range(3):
            r.render_frame(sync=(i == 2))
        meds.append((time.time() - t0) / (3 * batch))
    m = statistics.median(meds)
    print(f"{label}: {m:.3f} s/{'spp' if batch > 1 else 'frame'}", flush=True)
    return m

VARIANTS = {
    "full": dict(),
    "nonee": dict(nee_enabled=False),
    "shadowrev": dict(shadow_rev=True),
    # compaction bisect: phase-transition argsort+gather cost
    "nocompact": dict(compaction=False),
    "coarse2": dict(compaction_divs=(8, 64)),
    "fine4": dict(compaction_divs=(2, 8, 32, 128)),
    "batch4": dict(frame_batch=4),
    "batch8": dict(frame_batch=8),
    "bounces8": dict(max_bounces=8),
    "bounces16": dict(max_bounces=16),
    # primary floor: camera gen + ONE coherent trace + shade glue (+NEE)
    "b0-nonee": dict(nee_enabled=False, max_bounces=0),
    "b0": dict(max_bounces=0),
    # traversal paths on the same frame
    "packet": dict(traversal="packet"),
    "perray": dict(traversal="perray"),
}

names = _ARGS.variants.split(",")
res = {}
for name in names:
    res[name] = frame(f"{name:<16}", **VARIANTS[name])
if "full" in res and "nonee" in res:
    print(f"NEE share (shadow rays + light sampling): "
          f"{res['full'] - res['nonee']:.3f} s")
