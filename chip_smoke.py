#!/usr/bin/env python
"""Smoke test of the renderer on NVIDIA GPUs: the quickest proof that the
system still starts and renders correctly on the card.

One card (no arguments):
  1. device check: the card's name and power limit; JAX must report a GPU.
  2. build: the CUDA traversal library (set-up time).
  3. traversal check on proc:sponza at 1920x1080: primary rays, one bounce
     of incoherent rays and the NEE shadow segments (ops/raysets.py). The
     CUDA kernel against the XLA per-lane traversal on the same card, and
     against brute force on a 4,096-ray subsample.
  4. renders through the default Renderer: Sponza 1920x1080 (wavefront,
     NEE, 64 bounces, 4 spp) and the bathroom with Beckmann and DoF at
     1280x720, 4 spp; every film finite with a positive mean.
  5. estimator check: wavefront 512 spp against the `reference`
     integrator 2048 spp on proc:cornell at 128x128; per-channel mean
     relative error <= 1 %.
  6. one CLI render to PNG, in this process.

--multi (four cards): only the paths users run across devices —
  the sample-sharded Renderer (mesh (4, 1): axis "samples" of 4) on the
  glTF demo scene at 1920x1080 against the one-card render at the same
  spp; the scene-partitioned closest-hit trace (ring and routed) on
  Sponza's bounce rays against the one-card trace, with no ray left in
  flight; one partitioned render step against a one-card frame. Films
  are compared by the z-score of their mean per-pixel difference.

Any failed check raises; the last stdout line, printed only when every
phase passed, is {"ok": true, "device": {...}}.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

EDGE_SHARE = 1e-4   # rays allowed to disagree: exact-edge hits, FMA-contracted
MEAN_REL_ERR = 0.01  # estimator check, per channel
# Two renders of one view with independent samples: per channel, the mean of
# the per-pixel differences within this many of its standard errors.
MAX_Z = 5.0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def device_check(count: int):
    import jax
    devs = jax.devices()
    print(f"jax devices: {devs}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"needs {count} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for line in smi.splitlines():
        print(line)
    return devs


def build_library() -> None:
    from gpupathtracer_tpu.ops import cuda_traverse
    t0 = time.perf_counter()
    cuda_traverse.register()
    print(f"set-up: CUDA traversal library ready in "
          f"{time.perf_counter() - t0:.2f} s")


def traversal_check(width: int, height: int, subsample: int = 4096) -> None:
    import jax
    import jax.numpy as jnp

    from bench import sponza_config
    from gpupathtracer_tpu.math.camera import generate_image_plane
    from gpupathtracer_tpu.ops.intersect import brute_force_closest_hit
    from gpupathtracer_tpu.ops.raysets import (compare_hits,
                                               compare_occlusion,
                                               make_ray_sets)
    from gpupathtracer_tpu.ops.traverse import (any_hit, closest_hit,
                                                trace_closest,
                                                trace_occluded)
    from gpupathtracer_tpu.scene import load_scene

    cfg = sponza_config(width, height)
    scene, meta = load_scene(cfg)
    sets = make_ray_sets(scene, generate_image_plane(cfg.camera), width,
                         height, stack_depth=meta.stack_depth,
                         leaf_size=meta.leaf_size)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    pick = jnp.asarray(jax.random.permutation(
        jax.random.PRNGKey(1), width * height)[:subsample])
    for name, (o, d, tm, act) in sets.items():
        ref = closest_hit(scene.bvh, scene.tri_geom, o, d, tm, act, **kw)
        bt, bp, _, _ = brute_force_closest_hit(scene.tri_geom, o[pick],
                                               d[pick], tm[pick])
        if name == "shadow":
            occ = trace_occluded(scene, o, d, tm, act, traversal="cuda", **kw)
            occ_xla = any_hit(scene.bvh, scene.tri_geom, o, d, tm, act, **kw)
            vs_xla = compare_occlusion(ref.t, tm, occ, act)
            vs_anyhit = compare_occlusion(jnp.where(occ_xla, 0.0, tm), tm,
                                          occ, act)
            vs_brute = compare_occlusion(bt, tm[pick], occ[pick], act[pick])
            print(f"traversal {name}: vs per-lane closest t<tmax "
                  f"{vs_xla}; vs per-lane any_hit {vs_anyhit}; "
                  f"vs brute force {vs_brute}")
            results = (vs_xla, vs_anyhit, vs_brute)
        else:
            hit = trace_closest(scene, o, d, tm, act, traversal="cuda", **kw)
            vs_xla = compare_hits(ref.t, ref.prim, hit.t, hit.prim, act)
            vs_brute = compare_hits(bt, bp, hit.t[pick], hit.prim[pick],
                                    act[pick])
            print(f"traversal {name}: vs per-lane {vs_xla}; "
                  f"vs brute force {vs_brute}")
            results = (vs_xla, vs_brute)
        for r in results:
            check(r["share"] <= EDGE_SHARE,
                  f"{name} disagreement {r} above {EDGE_SHARE}")


def render_check(label, cfg, spp: int):
    import numpy as np

    from gpupathtracer_tpu.render import Renderer
    t0 = time.perf_counter()
    r = Renderer(cfg)
    print(f"render {label}: {r.meta.num_triangles} tris, traversal "
          f"{r.traversal}, set-up {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r.render_frame(sync=True)
    first = time.perf_counter() - t0
    r.stats.finalize()
    rays_first = r.stats.rays_traced
    t0 = time.perf_counter()
    for i in range(spp - 1):
        r.render_frame(sync=(i == spp - 2))
    steady = (time.perf_counter() - t0) / max(spp - 1, 1)
    r.stats.finalize()
    mrays = ((r.stats.rays_traced - rays_first) / max(spp - 1, 1)
             / steady / 1e6)
    img = r.film_hdr()
    print(f"render {label}: {spp} spp, first frame {first:.2f} s (compile "
          f"included), then {steady:.4f} s/frame and {mrays:.1f} Mrays/s, "
          f"film mean {img.mean():.5f}")
    check(img.shape == (cfg.height, cfg.width, 3), f"{label} film shape")
    check(bool(np.isfinite(img).all()), f"{label} film finite")
    check(img.mean() > 0, f"{label} film mean positive")
    return r, img


def estimator_check() -> None:
    from gpupathtracer_tpu.render.parity import (estimator_parity,
                                                 parity_config)
    out = estimator_parity(parity_config("proc:cornell", 128), 512, 2048)
    print(f"estimator cornell 128x128, wavefront 512 spp vs reference "
          f"2048 spp: {json.dumps(out)}")
    check(max(out["mean_rel_err"]) <= MEAN_REL_ERR,
          f"per-channel mean error {out['mean_rel_err']} above "
          f"{MEAN_REL_ERR}")


def cli_check() -> None:
    from gpupathtracer_tpu import cli
    from gpupathtracer_tpu.utils.io import load_png
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        rc = cli.main(["proc:cornell", "--spp", "4", "--width", "256",
                       "--height", "192", "--skybox", "GENERATE COLOR BLACK",
                       "--out", out])
        check(rc == 0, "cli exit code")
        img = load_png(out)
    check(img.shape == (192, 256, 3) and img.mean() > 0, "cli PNG")
    print(f"cli: 256x192 PNG, mean {img.mean():.4f}")


def same_estimate(label: str, a, b) -> None:
    """Check that two films of one view, rendered with independent
    samples, estimate the same image: per channel the mean per-pixel
    difference lies within MAX_Z standard errors. Pixels are independent,
    and the image content cancels in the difference."""
    import numpy as np
    diff = (a - b).reshape(-1, 3).astype(np.float64)
    se = diff.std(axis=0) / np.sqrt(diff.shape[0])
    z = np.abs(diff.mean(axis=0)) / np.maximum(se, 1e-12)
    rel = np.abs(diff.mean(axis=0)) / np.maximum(
        b.reshape(-1, 3).mean(axis=0), 1e-6)
    print(f"{label}: channel means {a.reshape(-1, 3).mean(0).tolist()} vs "
          f"{b.reshape(-1, 3).mean(0).tolist()}, rel diff {rel.tolist()}, "
          f"standard error {se.tolist()}, z {z.tolist()} (limit {MAX_Z})",
          flush=True)
    check(bool(np.isfinite(a).all()) and a.mean() > 0,
          f"{label}: film finite and lit")
    check(float(z.max()) <= MAX_Z, f"{label}: z {z.tolist()} above {MAX_Z}")


def sharded_check(width: int, height: int, spp: int, n_dev: int) -> None:
    """The sample-sharded Renderer on the glTF demo scene against the
    one-device render at the same spp."""
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu.render import Renderer
    from gpupathtracer_tpu.scene.samplegen import write_demo_gltf

    with tempfile.TemporaryDirectory() as tmp:
        path = write_demo_gltf(os.path.join(tmp, "demo.gltf"))
        base = RenderConfig(scene_path=path, skybox="GENERATE COLOR BLACK",
                            width=width, height=height, ray_chunk=1 << 21)
        base.camera = CameraConfig(position=(0.0, 2.0, -6.0), yaw=math.pi,
                                   pitch=-0.15, fov=math.radians(50),
                                   aspect=width / height)
        sharded = Renderer(dataclasses.replace(base, mesh_shape=(n_dev, 1)))
        one = Renderer(base, scene=sharded.scene, meta=sharded.meta)
        t0 = time.perf_counter()
        while sharded.num_samples < spp:
            sharded.render_frame(sync=True)
        t_sh = time.perf_counter() - t0
        t0 = time.perf_counter()
        while one.num_samples < spp:
            one.render_frame(sync=True)
        t_one = time.perf_counter() - t0
    print(f"sharded glTF {width}x{height} {spp} spp on {n_dev} devices: "
          f"{t_sh:.2f} s (compile included) vs one device {t_one:.2f} s",
          flush=True)
    same_estimate("sharded glTF vs one device", sharded.film_hdr(),
                  one.film_hdr())


def partition_check(width: int, height: int, n_dev: int) -> None:
    """The scene-partitioned closest-hit trace (ring and routed) on
    Sponza's bounce rays against the one-device trace, and one partitioned
    render step against a one-device frame."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from bench import sponza_config
    from gpupathtracer_tpu.bvh.partition import build_partition
    from gpupathtracer_tpu.math.camera import generate_image_plane
    from gpupathtracer_tpu.ops.raysets import make_ray_sets
    from gpupathtracer_tpu.ops.traverse import trace_closest
    from gpupathtracer_tpu.parallel.partition import (
        shard_partition, trace_closest_partitioned)
    from gpupathtracer_tpu.render import Renderer

    cfg = sponza_config(width, height)
    r1 = Renderer(cfg)
    scene, meta = r1.scene, r1.meta
    o, d, tm, act = make_ray_sets(scene, generate_image_plane(cfg.camera),
                                  width, height,
                                  stack_depth=meta.stack_depth,
                                  leaf_size=meta.leaf_size)["bounce"]
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    ref = trace_closest(scene, o, d, tm, act, **kw)
    part = build_partition(np.asarray(scene.bvh.node_rows),
                           scene.bvh.child_bounds.shape[0], n_dev)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), axis_names=("chips",))
    tables, route = shard_partition(part, mesh)
    t_r, p_r = np.asarray(ref.t), np.asarray(ref.prim)
    n_act = int(jnp.sum(act))
    t_ring = None
    for routing in ("ring", "routed"):
        t0 = time.perf_counter()
        hit, stats = jax.block_until_ready(trace_closest_partitioned(
            mesh, tables, route, o, d, tm, act, routing=routing,
            with_stats=True, **kw))
        dt = time.perf_counter() - t0
        t_p, p_p = np.asarray(hit.t), np.asarray(hit.prim)
        # Contract: t always agrees; prims agree except at exact-t ties.
        bad = ~(np.isclose(t_p, t_r, rtol=1e-5, atol=1e-5)
                & ((p_p == p_r) | np.isclose(t_p, t_r, rtol=1e-6,
                                             atol=1e-6)))
        extra = ""
        if routing == "routed":
            s = np.asarray(stats)              # [D, 4, rounds + 1]
            in_flight = int(s[:, 3, -1].sum())
            delivered = int(s[:, 2].sum())
            rounds = int(np.nonzero(s[:, 1].sum(0))[0].max(initial=0))
            extra = (f", {rounds} exchange rounds, {delivered} of {n_act} "
                     f"active rays delivered, {in_flight} in flight at the "
                     f"end, t equal to the ring's: "
                     f"{bool(np.array_equal(t_p, t_ring))}")
        print(f"partitioned trace ({routing}, {n_dev} devices, "
              f"{len(t_p)} bounce rays): {int(bad.sum())} disagreements, "
              f"{dt:.2f} s (compile included){extra}", flush=True)
        check(not bad.any(), f"partitioned {routing}: {int(bad.sum())} "
              f"rays break the contract")
        if routing == "ring":
            t_ring = t_p
        else:
            check(in_flight == 0 and delivered == n_act,
                  f"routed: {in_flight} rays in flight, {delivered} of "
                  f"{n_act} delivered")
            check(bool(np.array_equal(t_p, t_ring)),
                  "routed t differs from the ring's")

    rp = Renderer(dataclasses.replace(cfg, partition_chips=n_dev),
                  scene=scene, meta=meta)
    t0 = time.perf_counter()
    rp.render_frame(sync=True)
    dt = time.perf_counter() - t0
    r1.render_frame(sync=True)
    print(f"partitioned render step {width}x{height} on {n_dev} devices: "
          f"{dt:.2f} s (compile included)", flush=True)
    same_estimate("partitioned render step vs one device", rp.film_hdr(),
                  r1.film_hdr())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    count = 4 if args.multi else 1
    devs = device_check(count)

    from gpupathtracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    build_library()
    if args.multi:
        sharded_check(1920, 1080, spp=4, n_dev=count)
        partition_check(1920, 1080, n_dev=count)
    else:
        traversal_check(1920, 1080)
        from bench import proc_config, sponza_config
        render_check("sponza 1920x1080", sponza_config(1920, 1080), spp=4)
        render_check("bathroom 1280x720 beckmann+dof",
                     proc_config("proc:bathroom", 1280, 720,
                                 microfacet="beckmann", max_bounces=64),
                     spp=4)
        estimator_check()
        cli_check()
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
