#!/usr/bin/env python
"""Traversal A/B on the GPU: the CUDA per-thread kernel against the XLA
packet and per-lane traversals, on the three ray sets of a 1080p Sponza
view (ops/raysets.py), and optionally on the whole default frame.

Every traversal is first checked against the per-lane reference; times
are medians of --reps runs, each ended by block_until_ready, after one
warm-up call. Prints one line per measurement and writes them all as JSON
to chiprun_out/kernel_bench.json.

Usage:
  python tools/kernel_bench.py [--reps 5] [--frame] [--check-only]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _median_s(fn, reps):
    import jax
    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frame", action="store_true",
                    help="also time the default Sponza frame per traversal")
    ap.add_argument("--check-only", action="store_true",
                    help="correctness only, no timing")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import sponza_config
    from gpupathtracer_tpu.math.camera import generate_image_plane
    from gpupathtracer_tpu.ops import cuda_traverse
    from gpupathtracer_tpu.ops.raysets import (compare_hits,
                                               compare_occlusion,
                                               make_ray_sets)
    from gpupathtracer_tpu.ops.traverse import (any_hit, closest_hit,
                                                trace_rows)
    from gpupathtracer_tpu.render import Renderer
    from gpupathtracer_tpu.scene import load_scene
    from gpupathtracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_bench measures the GPU; found {dev}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"# card: {card}; jax: {dev.device_kind} x{len(jax.devices())}")
    t0 = time.perf_counter()
    cuda_traverse.register()
    print(f"# CUDA library ready in {time.perf_counter() - t0:.2f} s")

    cfg = sponza_config(args.width, args.height)
    t0 = time.perf_counter()
    scene, meta = load_scene(cfg)
    print(f"# scene {meta.num_triangles} tris, table "
          f"{scene.bvh.node_rows.shape[0]} rows, stack {meta.stack_depth}, "
          f"load {time.perf_counter() - t0:.1f} s")
    cam = generate_image_plane(cfg.camera)
    sets = make_ray_sets(scene, cam, args.width, args.height,
                         stack_depth=meta.stack_depth,
                         leaf_size=meta.leaf_size)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    rows = scene.bvh.node_rows
    out = {"card": card, "device_kind": dev.device_kind, "rows": {}}

    def run(trav, any_, o, d, tm, act):
        if trav == "perray":
            if any_:
                return jax.jit(lambda: (None, any_hit(
                    scene.bvh, scene.tri_geom, o, d, tm, act, **kw)))
            return jax.jit(lambda: closest_hit(scene.bvh, scene.tri_geom,
                                               o, d, tm, act, **kw)[:2])
        if trav == "cuda":
            def f():
                t, prim, *_ = cuda_traverse.traverse_rows_cuda(
                    rows, o, d, tm, act, stack_depth=meta.stack_depth,
                    any_hit=any_)
                return (t, prim >= 0) if any_ else (t, prim)
            return jax.jit(f)

        def g():
            t, prim, *_ = trace_rows(rows, o, d, tm, act, traversal=trav,
                                     any_hit=any_, **kw)
            return (t, prim >= 0) if any_ else (t, prim)
        return jax.jit(g)

    variants = ["cuda"] if args.check_only else ["cuda", "packet", "perray"]
    for set_name, (o, d, tm, act) in sets.items():
        any_ = set_name == "shadow"
        ref_t, ref_prim = closest_hit(scene.bvh, scene.tri_geom, o, d, tm,
                                      act, **kw)[:2]
        n_act = int(jnp.sum(act))
        for trav in variants:
            fn = run(trav, any_, o, d, tm, act)
            res = fn()
            if any_:
                cmp = compare_occlusion(ref_t, tm, res[1], act)
            else:
                cmp = compare_hits(ref_t, ref_prim, res[0], res[1], act)
            row = {"check": cmp}
            if not args.check_only:
                med, lo, hi = _median_s(fn, args.reps)
                row.update(ms=med * 1e3, ms_min=lo * 1e3, ms_max=hi * 1e3,
                           mrays_s=n_act / med / 1e6)
            out["rows"][f"{set_name}/{trav}"] = row
            print(f"{set_name:8s} {trav:8s} {json.dumps(row)}", flush=True)

    if args.frame:
        import dataclasses
        out["frame"] = {}
        for trav in variants:
            r = Renderer(dataclasses.replace(cfg, traversal=trav),
                         scene=scene, meta=meta)
            t0 = time.perf_counter()
            r.render_frame(sync=True)
            first = time.perf_counter() - t0
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                r.render_frame(sync=True)
                times.append(time.perf_counter() - t0)
            r.stats.finalize()
            img = r.film_hdr()
            row = {"first_s": first, "s_per_frame": statistics.median(times),
                   "min": min(times), "max": max(times),
                   "mrays_s": r.stats.rays_traced / len(r.stats.frame_times)
                   / statistics.median(times) / 1e6,
                   "film_mean": float(img.mean())}
            out["frame"][trav] = row
            print(f"frame    {trav:8s} {json.dumps(row)}", flush=True)
            del r

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_bench.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
