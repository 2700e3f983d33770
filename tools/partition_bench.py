#!/usr/bin/env python
"""Measure the partitioned-traversal routing statistics.

A cost model for the multi-device scene partition (devices own subtrees,
rays migrate between them) rests on two quantities this tool MEASURES
instead of assumes, on a real scene with D=8 virtual CPU devices:

  - hops/ray V: how many of the D subtree visits actually traverse
    (the routing mask prunes the rest) — the compute-per-hop input;
  - per-chip load balance: total routed rays per chip (the tail-latency
    input — the slowest chip gates each hop's barrier).

Runs coherent (camera) and incoherent (random) ray populations, closest
and any-hit. Runs on the CPU mesh by default.

Usage: python tools/partition_bench.py [--scene proc:sponza] [--n 65536]

--hardware: runs the same partition on the real devices JAX exposes (four
GPUs), adds wall-clock timing (median of >= 3 back-to-back reps, each
ended by block_until_ready), and measures the per-hop barrier floor: a
ring traversal whose rays are all DEAD routes nothing and pops nothing,
so its wall is (D-1) hop barriers + dispatch.
"""
import argparse
import math
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_HW = "--hardware" in sys.argv
if not _HW:
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import jax

if not _HW:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="proc:sponza")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--grouping", default="spatial",
                    choices=["spatial", "spatial-area", "demand", "lpt"])
    ap.add_argument("--replicate-hot", type=int, default=6)
    ap.add_argument("--hot-demand", default="random",
                    choices=["random", "camera", "mixed", "pilot"],
                    help="hot-selection demand estimate: slab-entry "
                         "counts of random interior rays (default), "
                         "camera primaries, a 50/50 mix — or 'pilot': "
                         "POPS-ATTRIBUTED per-lane node-visit counts of "
                         "the 50/50 pilot batch (sees traversal depth)")
    ap.add_argument("--routing", default="ring",
                    choices=["ring", "routed"],
                    help="ray-migration scheme: static ppermute ring "
                         "(default) or demand-routed all_to_all exchange "
                         "(rays hop only to chips they need)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="routed mode: cap on the exchange rounds "
                         "(default 8 * chips; rounds stop once every ray "
                         "is home)")
    ap.add_argument("--bucket-cap", type=int, default=None,
                    help="routed mode: per-destination bucket size B "
                         "(default ceil(n_shard / chips))")
    ap.add_argument("--populations", default="all",
                    help="comma list of configs to run: coherent, deal, "
                         "incoherent, anyhit (default all)")
    ap.add_argument("--baseline", action="store_true",
                    help="also trace the replicated WHOLE tree (single "
                         "chip, same kernel/packets) and report its "
                         "pops/ray — the denominator of the modeled "
                         "multi-chip compute win")
    ap.add_argument("--hardware", action="store_true",
                    help="run on the real devices jax exposes (no CPU "
                         "forcing, no virtual mesh) and add wall-clock "
                         "timing + a measured per-hop barrier floor "
                         "(see module doc)")
    ap.add_argument("--reps", type=int, default=3,
                    help="--hardware: timed repetitions per config")
    args = ap.parse_args()

    from gpupathtracer_tpu.bvh.partition import build_partition
    from gpupathtracer_tpu.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu.math.camera import gen_rays, generate_image_plane
    from gpupathtracer_tpu.parallel.mesh import make_device_mesh
    from gpupathtracer_tpu.parallel.partition import (
        shard_partition, trace_closest_partitioned)
    from gpupathtracer_tpu.scene import load_scene
    from jax.sharding import Mesh

    D = args.chips
    cfg = RenderConfig(scene_path=args.scene, skybox="GENERATE COLOR BLACK",
                       width=256, height=256)
    if args.scene == "proc:sponza":
        cfg.camera = CameraConfig(position=(-18.0, 4.5, 0.0),
                                  yaw=math.pi / 2, pitch=-0.05,
                                  fov=math.radians(60), aspect=1.0)
    else:
        from gpupathtracer_tpu.scene.procedural import default_camera
        pos, yaw, pitch, fov, aperture, focus = default_camera(args.scene)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=1.0,
                                  aperture=aperture, focal_distance=focus)
    scene, meta = load_scene(cfg)
    rows = np.asarray(scene.bvh.node_rows)

    # Scene bounds from the wide root's child boxes (empty slots are
    # inverted +-inf boxes; drop them).
    root_b = rows[0, 0:48].reshape(8, 6)
    valid = root_b[:, 0] <= root_b[:, 3]
    lo = root_b[valid, 0:3].min(0)
    hi = root_b[valid, 3:6].max(0)

    n = args.n
    key = jax.random.PRNGKey(7)

    # Coherent population: camera rays.
    cam = generate_image_plane(cfg.camera)
    side = int(math.isqrt(n))
    idx = jnp.arange(side * side)
    px = (idx % side).astype(jnp.float32) / side
    py = (idx // side).astype(jnp.float32) / side
    o_c, d_c = gen_rays(cam, jnp.stack([px, py], 1),
                        jnp.full((side * side, 2), 0.5))
    # shard_map needs the ray count to divide the chip count; trim the
    # grid tail (statistics are population-level, a <D-ray trim is noise).
    nc = side * side // D * D
    o_c, d_c = o_c[:nc], d_c[:nc]

    # Incoherent population: random origins inside the scene bounds,
    # random directions (the bounce-wavefront stand-in, kernel_bench's
    # convention).
    ko, kd = jax.random.split(key)
    o_i = jax.random.uniform(ko, (n, 3), minval=jnp.asarray(lo),
                             maxval=jnp.asarray(hi))
    d_i = jax.random.normal(kd, (n, 3))
    d_i = d_i / jnp.linalg.norm(d_i, axis=1, keepdims=True)

    demand_rays = None
    hot_entries = None
    if args.hot_demand == "camera":
        demand_rays = (np.asarray(o_c), np.asarray(d_c))
    elif args.hot_demand == "mixed":
        h = min(nc, n) // 2
        demand_rays = (
            np.concatenate([np.asarray(o_c)[:h], np.asarray(o_i)[:h]]),
            np.concatenate([np.asarray(d_c)[:h], np.asarray(d_i)[:h]]))
    elif args.hot_demand == "pilot" and args.replicate_hot > 0:
        from gpupathtracer_tpu.bvh.partition import (node_bucket_map,
                                                     partition_cut)
        from gpupathtracer_tpu.ops.traverse import count_entry_visits
        W = scene.bvh.child_bounds.shape[0]
        cut_e, _ = partition_cut(rows, W, D)
        bucket = node_bucket_map(rows, W, cut_e)
        h = min(nc, n) // 2
        po = jnp.concatenate([o_c[:h], o_i[:h]])
        pd = jnp.concatenate([d_c[:h], d_i[:h]])
        counts = np.asarray(count_entry_visits(
            scene.bvh, scene.tri_geom, po, pd,
            jnp.full((2 * h,), 1e20, jnp.float32), bucket,
            len(cut_e) + 1, stack_depth=meta.stack_depth,
            leaf_size=meta.leaf_size))[:len(cut_e)]
        hot_entries = np.argsort(-counts)[:args.replicate_hot]
        print(f"# pilot demand: top entries {hot_entries.tolist()} "
              f"visits {counts[hot_entries].tolist()} of "
              f"{counts.sum()} total", flush=True)

    if args.hardware:
        avail = len(jax.devices())
        if avail < D:
            print(f"# --hardware: only {avail} real device(s) present "
                  f"(asked for {D}); running D={avail}.",
                  flush=True)
            D = max(avail, 1)
        print(f"# --hardware: devices = {jax.devices()[:D]}", flush=True)

    part = build_partition(rows, scene.bvh.child_bounds.shape[0], D,
                           grouping=args.grouping,
                           replicate_hot=args.replicate_hot,
                           demand_rays=demand_rays,
                           hot_entries=hot_entries)
    devs = np.asarray(jax.devices()[:D]).reshape(D,)
    mesh = Mesh(devs, axis_names=("chips",))
    tables, dev_bounds = shard_partition(part, mesh)
    print(f"# {args.scene}: whole table {rows.shape[0]} rows; per-chip "
          f"{tables.shape[1]} rows (pad incl.); grouping={args.grouping}; "
          f"replicate_hot={args.replicate_hot}; "
          f"hot_demand={args.hot_demand}; "
          f"live rows/chip={part.num_rows.tolist()}", flush=True)

    def _timed(o, d, tm, act, any_hit, tag=""):
        """--hardware wall clock: warm once, then median of --reps
        back-to-back calls, each ended by block_until_ready."""
        def call():
            hit, _ = trace_closest_partitioned(
                mesh, tables, dev_bounds, o, d, tm, act,
                stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
                any_hit=any_hit, with_stats=True, routing=args.routing,
                max_rounds=args.rounds, bucket_cap=args.bucket_cap)
            return jax.block_until_ready(hit)
        call()  # warm/compile
        ts = []
        for _ in range(max(args.reps, 1)):
            t0 = time.time()
            call()
            ts.append(time.time() - t0)
        med = statistics.median(ts)
        spread = (max(ts) - min(ts)) / med if med else 0.0
        print(f"   WALL {tag}: {med*1e3:.2f} ms/traversal (spread "
              f"{spread:.0%}, reps {len(ts)}), "
              f"{len(act)/med/1e6:.2f} Mrays/s", flush=True)
        return med

    def run(tag, o, d, m, any_hit, tmax=None):
        tm = (jnp.full((m,), 1e20, jnp.float32) if tmax is None
              else jnp.full((m,), tmax, jnp.float32))
        act = jnp.ones((m,), bool)
        out = trace_closest_partitioned(
            mesh, tables, dev_bounds, o, d, tm, act,
            stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
            any_hit=any_hit, with_stats=True, routing=args.routing,
            max_rounds=args.rounds, bucket_cap=args.bucket_cap)
        _, stats = out
        if args.hardware:
            _timed(o, d, tm, act, any_hit, tag=tag)
        if args.routing == "routed":
            return run_routed_report(tag, stats, m)
        s = np.asarray(stats)          # [D_chip, 3, D_hop]
        routed, improved, pops = s[:, 0, :], s[:, 1, :], s[:, 2, :]
        per_chip = routed.sum(1)       # total routed rays per chip
        per_hop = routed.sum(0)        # total routed per hop index
        v = routed.sum() / m
        imb = per_chip.max() / max(per_chip.mean(), 1e-9)
        # Wall-clock proxy: every hop is a barrier, so the slowest chip
        # gates it — sum over hops of the max-over-chips count, vs the
        # perfectly-balanced sum/D. POPS (node+leaf kernel pops) is the
        # honest work unit: a routed 'visit' is not comparable across
        # replicate_hot settings (hop 0's root spans steady + hot).
        barrier = routed.max(0).sum()
        ideal = routed.sum() / routed.shape[0]
        pbar = pops.max(0).sum()
        pideal = pops.sum() / pops.shape[0]
        print(f"{tag}: hops/ray V = {v:.2f} of {routed.shape[1]}, "
              f"improved/ray = {improved.sum()/m:.2f}, "
              f"chip load max/mean = {imb:.2f}, "
              f"barrier cost/ideal = {barrier/max(ideal, 1e-9):.2f}",
              flush=True)
        print(f"   pops/ray = {pops.sum()/m:.2f}, pops barrier/ideal = "
              f"{pbar/max(pideal, 1e-9):.2f}, wall proxy (max pops/hop "
              f"summed)/ray = {pbar/m:.2f}", flush=True)
        print(f"   per-chip routed: {per_chip.tolist()}", flush=True)
        print(f"   per-chip pops  : {pops.sum(1).tolist()}", flush=True)
        print(f"   per-hop routed : {per_hop.tolist()}", flush=True)
        return v, imb

    def run_routed_report(tag, stats, m):
        """Routed-mode stats: [D, 4, R+1] per-(chip, round) pops /
        transported / delivered / live-at-end (col 0 = home hop). The
        wall proxy stays sum-over-rounds of max-over-chips pops (each
        all_to_all is the barrier the ppermute hop was)."""
        s = np.asarray(stats)
        pops, sent = s[:, 0, :], s[:, 1, :]
        dlvr, live = s[:, 2, :], s[:, 3, :]
        undeliv = int(live[:, -1].sum())
        used = int(max(np.nonzero(pops.sum(0) + sent.sum(0))[0], default=0)) + 1
        pbar = pops.max(0).sum()
        pideal = pops.sum() / pops.shape[0]
        n_shard = m // D
        B = args.bucket_cap or -((-n_shard) // D)
        B = max(8, -((-B) // 8) * 8)
        useful_mb = sent.sum() * 52 / 1e6
        bucket_mb = (used - 1) * D * D * B * 52 / 1e6
        ring_mb = m * 44 * (D - 1) / 1e6
        print(f"{tag}: pops/ray = {pops.sum()/m:.2f}, pops barrier/ideal "
              f"= {pbar/max(pideal, 1e-9):.2f}, wall proxy (max pops/"
              f"round summed)/ray = {pbar/m:.2f}", flush=True)
        print(f"   rounds used = {used-1} of {pops.shape[1]-1}, "
              f"transported/ray = {sent.sum()/m:.2f}, undelivered = "
              f"{undeliv}", flush=True)
        print(f"   bytes moved: useful {useful_mb:.2f} MB, bucket-padded "
              f"{bucket_mb:.2f} MB vs ring {ring_mb:.2f} MB", flush=True)
        print(f"   per-chip pops  : {pops.sum(1).tolist()}", flush=True)
        print(f"   per-round pops : {pops.sum(0).tolist()}", flush=True)
        print(f"   per-round sent : {sent.sum(0).tolist()}", flush=True)
        print(f"   per-round dlvr : {dlvr.sum(0).tolist()}", flush=True)
        return pops.sum() / m, pbar / max(pideal, 1e-9)

    def run_whole(tag, o, d, m, any_hit, tmax=None):
        """Replicated whole-tree pops/ray — same traversal, one device:
        the single-table work the partition is judged against."""
        from gpupathtracer_tpu.ops.traverse import (resolve_traversal,
                                                    trace_rows)
        tm = jnp.full((m,), 1e20 if tmax is None else tmax, jnp.float32)
        *_, pops = trace_rows(
            jnp.asarray(rows), o[:m], d[:m], tm, jnp.ones((m,), bool),
            traversal=resolve_traversal("auto"),
            stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
            any_hit=any_hit)
        print(f"{tag} WHOLE-TREE: pops/ray = {int(pops)/m:.2f} "
              f"({m} rays, table {rows.shape[0]} rows)", flush=True)

    pops_sel = (set(args.populations.split(","))
                if args.populations != "all"
                else {"coherent", "deal", "incoherent", "anyhit"})
    if "coherent" in pops_sel:
        run("coherent  closest", o_c, d_c, nc, False)
    if "deal" in pops_sel:
        # Pixel->chip assignment A/B for the coherent population: the
        # per-hop barrier follows the RAYS (which image region does deep
        # work), not the subtree ownership — hot replication measured
        # invariant on it. "deal" hands every D-th pixel (in raster or
        # Morton order) to the same chip: each chip's shard mixes sky and
        # geometry, trading within-packet coherence for barrier balance.
        from gpupathtracer_tpu.utils.morton import ray_order
        deal = np.argsort(np.arange(nc) % D, kind="stable")
        run("coherent  closest [deal]", o_c[deal], d_c[deal], nc, False)
        mo = ray_order(side, side, "morton")
        mdeal = mo[np.argsort(np.arange(nc) % D, kind="stable")]
        run("coherent  closest [morton-deal]", o_c[mdeal], d_c[mdeal], nc,
            False)
    if "incoherent" in pops_sel:
        run("incoherent closest", o_i, d_i, n, False)
    if "anyhit" in pops_sel:
        run("incoherent any-hit (tmax=20)", o_i, d_i, n, True, tmax=20.0)
    if args.baseline:
        run_whole("coherent  closest", o_c, d_c, nc, False)
        run_whole("incoherent closest", o_i, d_i, n, False)
        run_whole("incoherent any-hit (tmax=20)", o_i, d_i, n, True,
                  tmax=20.0)

    if args.hardware:
        # Per-hop barrier floor: an all-DEAD wavefront routes nothing and
        # pops nothing, so the ring traversal's wall clock is (D-1) hop
        # barriers + per-hop dispatch.
        m = min(args.n, 65536) // D * D
        o0 = jnp.zeros((m, 3), jnp.float32)
        d0 = jnp.zeros((m, 3), jnp.float32).at[:, 0].set(1.0)
        tm0 = jnp.zeros((m,), jnp.float32)
        act0 = jnp.zeros((m,), bool)
        wall = _timed(o0, d0, tm0, act0, False, tag="all-dead hop floor")
        hops = max(D - 1, 1)
        print(f"# measured hop floor: {wall/hops*1e3:.2f} ms/hop over "
              f"{hops} hop(s); this floor carries ~zero payload — the "
              f"delta under load is the bandwidth term", flush=True)

    # Bytes/ray/hop is fixed at ~44; what V changes is the COMPUTE per
    # hop (masked rays still ride the ring but skip traversal).
    print("# model: bytes/ray/traversal = 44 * (D-1) regardless of V; "
          "per-hop compute scales with routed counts above.", flush=True)


if __name__ == "__main__":
    main()
