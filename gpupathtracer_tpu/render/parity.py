"""Estimator parity: the wavefront integrator against the independent
`reference` integrator on the same scene and camera.

The wavefront (NEE + MIS, the reference's Iterative.comp estimator
semantics) and the uniform-hemisphere ground truth (the reference's CPU
renderer role, src/core/Renderer.cpp:21-22) estimate the same image; their
per-channel means agree to within Monte Carlo noise when both are right.
"""

from __future__ import annotations

import math
import time

import numpy as np


def parity_config(scene: str, res: int, skybox: str | None = None):
    """Square pinhole view of `scene` (no DoF keeps the comparison sharp;
    both integrators share the lens model)."""
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig
    if skybox is None:  # the env-lit bunny scene has no emitter
        skybox = ("GENERATE COLOR WHITE" if scene == "proc:bunny"
                  else "GENERATE COLOR BLACK")
    cfg = RenderConfig(scene_path=scene, skybox=skybox, width=res,
                       height=res, ray_chunk=res * res, cache_enabled=True)
    if scene == "proc:cornell":
        cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                                  fov=math.radians(45), aspect=1.0)
    elif scene.startswith("proc:"):
        from gpupathtracer_tpu.scene.procedural import default_camera
        pos, yaw, pitch, fov, _, _ = default_camera(scene)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=1.0)
    return cfg


def estimator_parity(cfg, spp_wave: int, spp_ref: int) -> dict:
    """Render cfg with both integrators; returns per-channel means, the
    per-channel relative error of the mean, percentiles of the 4x4-blurred
    pixelwise relative error, and each side's seconds."""
    from gpupathtracer_tpu.render import Renderer

    r = Renderer(cfg)
    t0 = time.perf_counter()
    while r.num_samples < spp_wave:
        r.render_frame("wavefront")
    img_w = r.film_hdr()
    t_wave = time.perf_counter() - t0

    r2 = Renderer(cfg, scene=r.scene, meta=r.meta)
    t0 = time.perf_counter()
    for _ in range(spp_ref):
        r2.render_frame("reference")
    img_r = r2.film_hdr()
    t_ref = time.perf_counter() - t0

    if not (np.isfinite(img_w).all() and np.isfinite(img_r).all()):
        raise FloatingPointError("non-finite film in the parity renders")
    mw = img_w.mean(axis=(0, 1))
    mr = img_r.mean(axis=(0, 1))
    mean_err = np.abs(mw - mr) / (mr + 1e-6)
    # Pixelwise relative error on a 4x4 box blur (kills residual MC noise).
    k = 4
    hh, ww = (img_w.shape[0] // k) * k, (img_w.shape[1] // k) * k

    def blur(img):
        return img[:hh, :ww].reshape(hh // k, k, ww // k, k, 3).mean(
            axis=(1, 3)).mean(-1)

    lw, lr = blur(img_w), blur(img_r)
    rel = np.abs(lw - lr) / (lr + 0.01 * lr.mean() + 1e-9)
    return {"mean_wavefront": mw.tolist(), "mean_reference": mr.tolist(),
            "mean_rel_err": mean_err.tolist(),
            "pixel_rel_err_p50_p95_p99": [float(np.percentile(rel, q))
                                          for q in (50, 95, 99)],
            "seconds_wavefront": t_wave, "seconds_reference": t_ref}
