"""Command-line renderer — the application layer.

Role of src/Program.cpp + scene.txt: load a scene config, render
progressively, save screenshots, report average FPS / Mrays. Headless
(renders to PNG) since accelerator hosts rarely have a display; the
reference's interactive WASD loop maps to --orbit/--position/--rotation
flags plus progressive sample accumulation.

Usage:
  python -m gpupathtracer_tpu.cli scene.txt --spp 64 --out render.png
  python -m gpupathtracer_tpu.cli proc:cornell --spp 16 --width 512 --height 512
  python -m gpupathtracer_tpu.cli proc:sponza --integrator reference --spp 4
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def build_config(args) -> "RenderConfig":
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig, load_scene_txt

    if args.scene.endswith(".txt"):
        cfg = load_scene_txt(args.scene, args.width, args.height)
    else:
        cfg = RenderConfig(scene_path=args.scene, skybox=args.skybox,
                           width=args.width, height=args.height)
        cfg.camera = CameraConfig(aspect=args.width / args.height)
    if args.scene.startswith("proc:") and not args.position:
        # Procedural scenes ship a framing (overridable with flags).
        from gpupathtracer_tpu.scene.procedural import default_camera
        dc = default_camera(args.scene)
        if dc:
            pos, yaw, pitch, fov, aperture, focus = dc
            cfg.camera.position = pos
            cfg.camera.yaw, cfg.camera.pitch = yaw, pitch
            args.fov = fov if args.fov == 45.0 else args.fov
            args.aperture = aperture if args.aperture == 0.0 else args.aperture
            args.focus = focus if args.focus == 90.0 else args.focus
    if args.position:
        cfg.camera.position = tuple(float(x) for x in args.position.split(","))
    if args.rotation:
        rot = [float(x) for x in args.rotation.split(",")]
        cfg.camera.yaw = rot[0]
        cfg.camera.pitch = rot[1] if len(rot) > 1 else 0.0
    cfg.camera.fov = math.radians(args.fov)
    cfg.camera.focal_distance = args.focus
    cfg.camera.aperture = args.aperture
    cfg.integrator = args.integrator
    cfg.microfacet = args.microfacet
    cfg.max_bounces = args.max_bounces
    cfg.nee_enabled = not args.no_nee
    cfg.seed = args.seed
    cfg.exposure = args.exposure
    cfg.tonemap = "none" if args.no_tonemap else "uncharted2"
    cfg.cache_enabled = not args.no_cache
    cfg.bvh_builder = args.bvh_builder
    cfg.sampler = args.sampler
    cfg.frame_batch = args.frame_batch
    cfg.shadow_rev = args.shadow_rev
    cfg.partition_chips = args.partition_chips
    cfg.partition_samples = args.partition_samples
    cfg.partition_routing = args.partition_routing
    cfg.mip_levels = args.mip_levels
    if args.chunk:
        cfg.ray_chunk = args.chunk
    return cfg


def main(argv=None) -> int:
    from gpupathtracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    p = argparse.ArgumentParser(
        prog="gpupathtracer_tpu",
        description="progressive path tracer (JAX; CUDA traversal on GPUs)")
    p.add_argument("scene", help="scene.txt, .obj, .gltf/.glb, or proc:<name>")
    p.add_argument("--spp", type=int, default=16, help="samples per pixel")
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--skybox", default="GENERATE COLOR WHITE")
    p.add_argument("--position", default=None, help="camera x,y,z")
    p.add_argument("--rotation", default=None, help="camera yaw,pitch (radians)")
    p.add_argument("--fov", type=float, default=45.0, help="vertical FoV, degrees")
    p.add_argument("--focus", type=float, default=90.0, help="focal distance")
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--integrator", default="wavefront",
                   choices=["wavefront", "direct", "reference", "ao"])
    p.add_argument("--microfacet", default="trowbridge_reitz",
                   choices=["trowbridge_reitz", "beckmann", "blinn_phong"])
    p.add_argument("--max-bounces", type=int, default=64)
    p.add_argument("--no-nee", action="store_true")
    p.add_argument("--no-tonemap", action="store_true")
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame-batch", type=int, default=1,
                   help="samples accumulated per dispatch (realtime knob)")
    p.add_argument("--shadow-rev", action="store_true",
                   help="trace NEE shadow rays from the light end")
    p.add_argument("--mip-levels", type=int, default=1,
                   help="texture mip pyramid depth (>1 enables trilinear "
                        "filtering with ray-cone LOD)")
    p.add_argument("--sampler", default="random", choices=["random", "ld"],
                   help="pixel jitter: threefry or R2 low-discrepancy")
    p.add_argument("--exposure", type=float, default=1.68)
    p.add_argument("--bvh-builder", default="auto",
                   choices=["auto", "cpp", "numpy"])
    p.add_argument("--chunk", type=int, default=0, help="rays per chunk")
    p.add_argument("--partition-chips", type=int, default=0,
                   help="scene-PARTITIONED multi-device render: devices "
                        "own BVH subtrees, rays migrate between them "
                        "(parallel/partition.py); needs that many devices")
    p.add_argument("--partition-samples", type=int, default=1,
                   help="sample replicas composed over the partition")
    p.add_argument("--partition-routing", default="ring",
                   choices=["ring", "routed"],
                   help="partitioned ray migration: static ppermute ring "
                        "(default) or demand-routed all_to_all exchange")
    p.add_argument("--hdr-out", default=None,
                   help="also dump the raw mean-radiance film as .npy")
    p.add_argument("--stats-json", default=None,
                   help="write render stats JSON here")
    p.add_argument("--save-every", type=int, default=0,
                   help="save a progressive screenshot every N samples")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="force a JAX platform (default: auto)")
    p.add_argument("--checkpoint", default=None,
                   help="save a resumable checkpoint here when done")
    p.add_argument("--resume", default=None,
                   help="resume a progressive render from this checkpoint")
    p.add_argument("--interactive", action="store_true",
                   help="live WASD camera loop in the terminal (ANSI "
                        "half-block frames; Program.cpp:103-146 role)")
    p.add_argument("--viewer-bench", type=int, default=0, metavar="N",
                   help="run N scripted navigation frames of the viewer "
                        "loop headless and report fps (no tty needed)")
    p.add_argument("--move-speed", type=float, default=1.0,
                   help="interactive camera move step (world units)")
    p.add_argument("--orbit", type=int, default=0, metavar="N",
                   help="render N frames orbiting the camera around its "
                        "look-at point (the interactive-camera role); "
                        "writes out-000.png ... out-NNN.png")
    args = p.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    cfg = build_config(args)
    from gpupathtracer_tpu.render import Renderer
    from gpupathtracer_tpu.utils.io import timestamped_name

    t0 = time.time()
    if args.resume:
        from gpupathtracer_tpu.render.checkpoint import load_checkpoint
        r = load_checkpoint(args.resume)
        print(f"resumed at {r.num_samples} spp", file=sys.stderr)
    else:
        r = Renderer(cfg)
    print(f"scene: {r.meta.num_triangles} tris, {r.meta.num_materials} "
          f"materials, {r.meta.num_lights} lights "
          f"({time.time() - t0:.1f}s)", file=sys.stderr)
    if r.meta.bvh_stats:
        print(r.meta.bvh_stats.report(), file=sys.stderr)

    out = args.out or timestamped_name(
        os.path.splitext(os.path.basename(args.scene))[0].replace(":", "_"))

    if args.viewer_bench:
        from gpupathtracer_tpu.render.viewer import bench_viewer
        fps, enc_ms = bench_viewer(r, frames=args.viewer_bench,
                                   move_speed=args.move_speed)
        print(f"viewer loop: {fps:.1f} fps over {args.viewer_bench} "
              f"navigation frames ({cfg.width}x{cfg.height}, "
              f"{args.integrator}; ANSI encode {enc_ms:.1f} ms/frame)")
        return 0

    if args.interactive:
        from gpupathtracer_tpu.render.viewer import run_viewer
        run_viewer(r, move_speed=args.move_speed)
        path = r.save_screenshot(out)
        print(path)
        return 0

    if args.orbit:
        # Turntable: rotate the camera position about the vertical axis
        # through its focus point, resetting accumulation per frame
        # (Program.cpp camera-move semantics).
        import numpy as np
        base_cfg = r.cfg.camera
        pos0 = np.asarray(base_cfg.position, np.float64)
        stem, ext = os.path.splitext(out)
        for f in range(args.orbit):
            ang = 2.0 * math.pi * f / args.orbit
            c, sn = math.cos(ang), math.sin(ang)
            import dataclasses as _dc
            cam = _dc.replace(base_cfg,
                              position=(pos0[0] * c - pos0[2] * sn, pos0[1],
                                        pos0[0] * sn + pos0[2] * c),
                              yaw=base_cfg.yaw + ang)
            r.set_camera(cam)
            for _ in range(args.spp):
                r.render_frame()
            frame_path = f"{stem}-{f:03d}{ext}"
            r.save_screenshot(frame_path)
            print(f"orbit frame {f + 1}/{args.orbit} -> {frame_path}",
                  file=sys.stderr)
        print(f"{args.orbit} frames | {r.stats.report()}", file=sys.stderr)
        print(out)
        return 0

    for s in range(args.spp):
        # First frame syncs (captures compile time); the rest enqueue async
        # and drain at screenshot/report time.
        r.render_frame(sync=(s == 0))
        if s == 0:
            print(f"first sample (incl. compile): "
                  f"{r.stats.frame_times[0]:.1f}s", file=sys.stderr)
        if args.save_every and (s + 1) % args.save_every == 0:
            r.save_screenshot(out)
            print(f"  {s + 1}/{args.spp} spp -> {out} "
                  f"({r.stats.mrays_per_sec:.1f} Mrays/s)", file=sys.stderr)

    path = r.save_screenshot(out)
    if args.checkpoint:
        from gpupathtracer_tpu.render.checkpoint import save_checkpoint
        save_checkpoint(r, args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    elapsed = time.time() - t0
    print(f"{args.spp} spp in {sum(r.stats.frame_times):.1f}s render "
          f"({elapsed:.1f}s total) | {r.stats.report()}", file=sys.stderr)
    print(path)

    if args.hdr_out:
        import numpy as np
        np.save(args.hdr_out, r.film_hdr())
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump({
                "spp": args.spp,
                "render_seconds": sum(r.stats.frame_times),
                "avg_fps": r.stats.avg_fps,
                "mrays_per_sec": r.stats.mrays_per_sec,
                "rays": r.stats.rays_traced,
                "triangles": r.meta.num_triangles,
                "config": json.loads(cfg.to_json()),
            }, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
