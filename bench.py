#!/usr/bin/env python
"""Headline benchmarks (BASELINE.md configurations) on one GPU.

Prints ONE JSON line: the headline metric (Mrays/s on the Sponza-class
1080p NEE frame) with the other rows in "extra", the device as JAX reports
it and the card's name and power limit. A row that fails is reported as
null with its error on stderr; the bench goes on with the next row.

Every number is the median of 3 back-to-back repeats, each ended by
block_until_ready; compile time is excluded (one warm frame first).

Usage: python bench.py [--quick]
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time


def sponza_config(width, height, **kw):
    """The Sponza-class camera every Sponza row and check uses."""
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig
    kw.setdefault("integrator", "wavefront")
    kw.setdefault("max_bounces", 64)
    cfg = RenderConfig(
        scene_path="proc:sponza", skybox="GENERATE COLOR BLACK",
        width=width, height=height,
        ray_chunk=1 << 21, cache_enabled=True, **kw)
    cfg.camera = CameraConfig(position=(-18.0, 4.5, 0.0), yaw=math.pi / 2,
                              pitch=-0.05, fov=math.radians(60),
                              aspect=width / height)
    return cfg


def proc_config(scene, width, height, **kw):
    """A procedural scene at its default camera (lens included)."""
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu.scene.procedural import default_camera
    kw.setdefault("ray_chunk", 1 << 21)
    kw.setdefault("cache_enabled", True)
    cfg = RenderConfig(scene_path=scene, skybox="GENERATE COLOR BLACK",
                       width=width, height=height, **kw)
    pos, yaw, pitch, fov, aperture, focus = default_camera(scene)
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=width / height,
                              aperture=aperture, focal_distance=focus)
    return cfg


def card_info() -> str:
    """`name, power limit` of the card, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _frames_per_s(cfg, frames=8, reps=3):
    """Median samples per second over reps of `frames` frames."""
    from gpupathtracer_tpu.render import Renderer
    r = Renderer(cfg)
    r.render_frame(sync=True)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(frames):
            r.render_frame(sync=(i == frames - 1))
        rates.append(frames * max(cfg.frame_batch, 1)
                     / (time.perf_counter() - t0))
    del r
    gc.collect()
    return statistics.median(rates)


def _sponza_headline(width, height):
    from gpupathtracer_tpu.render import Renderer
    t0 = time.perf_counter()
    r = Renderer(sponza_config(width, height))
    r.render_frame(sync=True)
    first_s = time.perf_counter() - t0
    per_frame, rays = [], []
    for _ in range(3):
        r.stats.frame_times.clear()
        r.stats.rays_traced = 0
        t0 = time.perf_counter()
        for i in range(3):
            r.render_frame(sync=(i == 2))
        per_frame.append((time.perf_counter() - t0) / 3)
        r.stats.finalize()
        rays.append(r.stats.rays_traced / 3)
    med = statistics.median(per_frame)
    print(f"# scene: {r.meta.bvh_stats.report()}", file=sys.stderr)
    del r
    gc.collect()
    return {"res": f"{width}x{height}", "median_frame_s": med,
            "spread": (max(per_frame) - min(per_frame)) / med,
            "first_frame_s": first_s,
            "mrays_s": statistics.median(rays) / med / 1e6}


def _bathroom_seconds(width, height, spp):
    from gpupathtracer_tpu.render import Renderer
    r = Renderer(proc_config("proc:bathroom", width, height,
                             microfacet="beckmann", max_bounces=64))
    r.render_frame(sync=True)
    r.reset_samples()
    t0 = time.perf_counter()
    for i in range(spp):
        r.render_frame(sync=(i == spp - 1))
    dt = time.perf_counter() - t0
    del r
    gc.collect()
    return dt


def main() -> int:
    import jax

    from gpupathtracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev}")
    card = card_info()
    print(f"# card: {card}", file=sys.stderr)
    quick = "--quick" in sys.argv
    extra = {}

    def row(key, fn):
        try:
            extra[key] = fn()
        except Exception as e:  # one failed row must not hide the others
            extra[key] = None
            print(f"# {key} FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
        print(f"# {key}: {extra[key]}", file=sys.stderr)

    if not quick:
        row("table_direct_fps", lambda: _frames_per_s(proc_config(
            "proc:table", 800, 600, integrator="direct", max_bounces=0)))
        row("table_direct_batched_spp_s", lambda: _frames_per_s(proc_config(
            "proc:table", 800, 600, integrator="direct", max_bounces=0,
            frame_batch=8)))
        row("table_pt_fps", lambda: _frames_per_s(proc_config(
            "proc:table", 800, 600, integrator="wavefront",
            max_bounces=64)))
        row("bunny_direct_fps", lambda: _frames_per_s(proc_config(
            "proc:bunny", 512, 512, integrator="direct", max_bounces=0)))
    row("realtime_direct_fps", lambda: _frames_per_s(sponza_config(
        640, 360, integrator="direct", max_bounces=1)))
    width, height = (640, 360) if quick else (1920, 1080)
    row("sponza", lambda: _sponza_headline(width, height))
    if not quick:
        row("bathroom_256spp_s", lambda: _bathroom_seconds(640, 360, 256))
        row("bathroom_1024spp_720p_s",
            lambda: _bathroom_seconds(1280, 720, 1024))

    headline = extra.get("sponza") or {}
    print(json.dumps({
        "metric": f"mrays_per_sec_sponza_{height}p",
        "value": headline.get("mrays_s"),
        "unit": "Mrays/s",
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
