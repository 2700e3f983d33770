"""Wavefront path-tracing integrator — the flagship model.

A redesign of the reference's persistent-thread megakernel
(src/shaders/Iterative.comp:214-307): the whole sample wavefront advances
through a bounded `lax.while_loop` over bounces with SoA state in HBM; dead
lanes are masked instead of atomically replaced (the refill role of
InitRay's atomic pool is played by the caller tiling the film into chunks).
Estimator semantics are replicated exactly:

  - thin-lens primary rays with pixel jitter (InitRay, Iterative.comp:185-196)
  - emissive/env accumulation with the MIS throughput rewrite for i>0 hits
    (Iterative.comp:246-259, incl. the 0.5 lobe factor and neePdf =
    0.5/totalLightArea carried from InitRay:203)
  - NEE shadow ray + balance-heuristic weight (GenerateLightSample)
  - two-lobe BSDF importance sampling; throughput *= f * ndi * w / pdf
    (Iterative.comp:282-284)
  - Russian roulette with luminance clamp + 64-bounce cap (291-300)
  - 0.003 * normal hit offset (237), 0.001 * normal shadow offset (141)

RNG is counter-based threefry keyed by (seed, sample, bounce): renders are
bitwise reproducible, unlike the reference's stateful HybridTaus.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.math.camera import CameraParams, gen_rays
from gpupathtracer_tpu.math.vecmath import avdot, dot
from gpupathtracer_tpu.models.bsdf import compute_bsdf, mis_weight
from gpupathtracer_tpu.models.interaction import make_interaction
from gpupathtracer_tpu.models.materials import make_material_instance
from gpupathtracer_tpu.models.microfacet import generate_importance_sample
from gpupathtracer_tpu.models.nee import generate_light_sample
from gpupathtracer_tpu.ops.traverse import trace_closest, trace_occluded
from gpupathtracer_tpu.scene.envmap import sample_env

T_MAX = 1e20


def render_sample_impl(scene, cam: CameraParams, pixel_x, pixel_y, key,
                       width: int, height: int,
                       model: str = "trowbridge_reitz",
                       max_bounces: int = 64,
                       stack_depth: int = 48,
                       leaf_size: int = 4,
                       nee: bool = True,
                       traversal: str = "auto",
                       packet_size: int = 128,
                       textured: bool = False,
                       mips: bool = False,
                       sun: bool = False,
                       sun_mode: str = "disk",
                       sort_rays: bool = False,
                       shadow_rev: bool = False,
                       delta: bool = False,
                       compaction: bool = True,
                       compaction_divs: tuple = (2, 4, 8, 16, 32, 64, 128),
                       compaction_min: int = 2048,
                       sampler: str = "random",
                       partition=None,
                       partition_axis: str = "",
                       partition_routing: str = "ring",
                       num_chips: int = 0,
                       sample_idx=0):
    """Trace one sample for each pixel lane.

    Args:
      scene: SceneData pytree (device arrays).
      cam: CameraParams.
      pixel_x, pixel_y: [N] int32 pixel coordinates for each lane.
      key: threefry key for this (sample, chunk).
      partition: optional (local_table [M', 128], dev_bounds) where
        dev_bounds is [D, 6] or a parallel/partition.py RouteInfo —
        scene-PARTITIONED multi-chip mode (parallel/partition.py): must be
        called inside shard_map over `partition_axis` with `num_chips`
        devices; every traversal rides the ppermute ring against per-chip
        subtree tables, and every wavefront loop condition becomes a psum
        so all chips execute the collectives in lockstep.
    Returns ([N, 3] radiance contributions, scalar i32 rays traced) — the
    ray counter plays the role of the reference's device-side globalNextRay
    statistics for Mrays/s reporting (SURVEY.md §5 tracing).
    """
    n = pixel_x.shape[0]
    if mips and textured:
        # Ray-cone LOD input: angular width of one pixel, recovered from
        # the traced camera basis (|vertical| = 2 tan(fov/2) * focal_dist,
        # and focal_dist = |lower_left + h/2 + v/2| since |direction|=1).
        _fd = jnp.linalg.norm(cam.lower_left + 0.5 * cam.horizontal
                              + 0.5 * cam.vertical)
        pixel_cone = (jnp.linalg.norm(cam.vertical)
                      / (jnp.maximum(_fd, 1e-6) * height))
    if partition is not None:
        # Scene-partitioned mode: traversal crosses devices, not a local
        # kernel choice; lane-reordering machinery stays off.
        sort_rays = False
        from gpupathtracer_tpu.parallel.partition import (
            trace_partitioned_local, trace_partitioned_routed)
        _ptrace = (trace_partitioned_routed
                   if partition_routing == "routed"
                   else trace_partitioned_local)
        part_table, part_bounds = partition

    def g_alive_any(c):
        """Loop condition, collective under partitioning: every chip must
        run the same while iterations or the in-body ppermutes deadlock."""
        a = jnp.any(c.alive)
        if partition is None:
            return a
        return jax.lax.psum(a.astype(jnp.int32), partition_axis) > 0

    def g_alive_max(c):
        """Per-chip max alive count (phase-transition safety: a chip may
        only shrink to the next buffer once ITS live count fits)."""
        s = jnp.sum(c.alive)
        if partition is None:
            return s
        return jax.lax.pmax(s, partition_axis)

    key, k_jitter, k_lens = jax.random.split(key, 3)
    if sampler == "ld":
        # Low-discrepancy pixel jitter: shared R2 point per sample index,
        # rotated per pixel (Cranley-Patterson). The reference carried the
        # same machinery unwired (Renderer.cpp:784-887); wiring it is an
        # opt-in extension (cfg.sampler = "ld").
        from gpupathtracer_tpu.math.sampling import (pixel_rotation,
                                                     r2_sequence)
        rot = pixel_rotation(pixel_y.astype(jnp.int32) * width
                             + pixel_x.astype(jnp.int32))
        jitter = jnp.mod(r2_sequence(jnp.asarray(sample_idx,
                                                 jnp.int32))[None, :]
                         + rot, 1.0)
    else:
        jitter = jax.random.uniform(k_jitter, (n, 2))
    interp = (jnp.stack([pixel_x, pixel_y], axis=-1) + jitter) \
        / jnp.array([width, height], jnp.float32)
    lens_u = jax.random.uniform(k_lens, (n, 2))
    ray_o, ray_d = gen_rays(cam, interp, lens_u)

    nee_pdf = 0.5 / scene.total_light_area  # InitRay, Iterative.comp:203

    # Scene bounds for the bounce-ray sort cells (root node's child union).
    root_lo = jnp.min(scene.bvh.child_bounds[0, :, 0:3], axis=0)
    root_hi = jnp.max(scene.bvh.child_bounds[0, :, 3:6], axis=0)
    inv_extent = 1.0 / jnp.maximum(root_hi - root_lo, 1e-6)

    def ray_sort_perm(o, d, alive):
        """Coherence sort for bounce wavefronts: dead lanes last (so whole
        packets die and the traversal's packet compaction skips them), live
        lanes grouped by direction octant then coarse origin cell. Replaces
        the role of the megakernel's warp-coherent Morton pixel pool for
        SECONDARY rays, which the reference never solved."""
        octant = ((d[:, 0] > 0).astype(jnp.int32)
                  + 2 * (d[:, 1] > 0).astype(jnp.int32)
                  + 4 * (d[:, 2] > 0).astype(jnp.int32))
        cell_f = jnp.clip((o - root_lo) * inv_extent, 0.0, 0.999) * 8.0
        cell = (cell_f[:, 0].astype(jnp.int32) * 64
                + cell_f[:, 1].astype(jnp.int32) * 8
                + cell_f[:, 2].astype(jnp.int32))
        key = jnp.where(alive, octant * 512 + cell, 1 << 20)
        return jnp.argsort(key)

    class Carry(NamedTuple):
        i: jnp.ndarray
        key: jnp.ndarray
        o: jnp.ndarray
        d: jnp.ndarray
        throughput: jnp.ndarray
        contribution: jnp.ndarray
        pdf0: jnp.ndarray
        pdf1: jnp.ndarray
        last_pos: jnp.ndarray
        alive: jnp.ndarray
        rays: jnp.ndarray

    init = Carry(
        i=jnp.int32(0), key=key, o=ray_o, d=ray_d,
        throughput=jnp.ones((n, 3), jnp.float32),
        contribution=jnp.zeros((n, 3), jnp.float32),
        pdf0=jnp.ones((n,), jnp.float32),
        pdf1=jnp.ones((n,), jnp.float32),
        last_pos=ray_o,
        alive=jnp.ones((n,), bool),
        rays=jnp.int32(0),
    )

    def body(c: Carry) -> Carry:
        nw = c.o.shape[0]  # current (phase) wavefront width
        key, k = jax.random.split(c.key)
        rnd = jax.random.uniform(k, (nw, 9))
        rays = c.rays + jnp.sum(c.alive, dtype=jnp.int32)

        t_max_full = jnp.full((nw,), T_MAX, jnp.float32)
        if partition is not None:
            from gpupathtracer_tpu.ops.traverse import Hit
            tt_, pp_, uu_, vv_ = _ptrace(
                part_table, part_bounds, c.o, c.d, t_max_full, c.alive,
                axis_name=partition_axis, num_devices=num_chips,
                stack_depth=stack_depth, leaf_size=leaf_size,
                packet_size=max(packet_size, 128))
            hit = Hit(t=tt_, prim=pp_, u=uu_, v=vv_)
        elif sort_rays:
            perm = ray_sort_perm(c.o, c.d, c.alive)
            hit_s = trace_closest(scene, c.o[perm], c.d[perm], t_max_full,
                                  c.alive[perm], stack_depth=stack_depth,
                                  leaf_size=leaf_size, traversal=traversal,
                                  packet_size=packet_size)
            inv = jnp.argsort(perm)
            hit = type(hit_s)(t=hit_s.t[inv], prim=hit_s.prim[inv],
                              u=hit_s.u[inv], v=hit_s.v[inv])
        else:
            hit = trace_closest(scene, c.o, c.d, t_max_full, c.alive,
                                stack_depth=stack_depth, leaf_size=leaf_size,
                                traversal=traversal, packet_size=packet_size)
        miss = hit.prim < 0
        prim = jnp.maximum(hit.prim, 0)

        # ONE packed row gather for (normal, uv, mat id, MATERIAL row): the
        # per-triangle pre-join (scenedata.py: cols 16:32 =
        # mat_rows[tri.mat]) removes the mat_rows[mat_id] gather from every
        # lane-bounce.
        shade = scene.tri_shade[prim]             # [N, 32]
        normal = shade[:, 0:3]
        pos = c.o + c.d * hit.t[..., None] + 0.003 * normal
        w = 1.0 - hit.u - hit.v
        uv = (shade[:, 5:7] * hit.u[..., None] + shade[:, 7:9] * hit.v[..., None]
              + shade[:, 3:5] * w[..., None])
        # Miss lanes carry triangle 0's material row — a valid row; every
        # use below is masked by miss/alive.
        mrow = shade[:, 16:32]
        lod = None
        if mips and textured:
            # Ray-cone mip LOD (segment-length approximation; the
            # reference has no mip path at all). Footprint in world units
            # = t * pixel_cone, stretched at grazing incidence; texels
            # covered = footprint * texel density (shade col 10, uv/world
            # units) * level-0 resolution.
            tex0 = jax.lax.bitcast_convert_type(mrow[:, 8], jnp.int32)
            rw = scene.atlas_rects[jnp.maximum(tex0, 0), 2].astype(
                jnp.float32)
            ndv = jnp.abs(dot(shade[:, 0:3], c.d))
            foot = hit.t * pixel_cone / jnp.maximum(ndv, 0.2)
            texels = foot * shade[:, 10] * rw
            lod = jnp.log2(jnp.maximum(texels, 1.0))
        mat = make_material_instance(scene, None, uv, textured, row=mrow,
                                     lod=lod)
        view_dir = -c.d
        inter = make_interaction(normal, view_dir)

        # --- L_e accumulation with MIS rewrite (Iterative.comp:246-259) ---
        emission = jnp.where(miss[..., None], sample_env(scene.env, c.d),
                             mat.emission)
        dvec = c.last_pos - pos
        dist2 = jnp.maximum(dot(dvec, dvec), 1e-12)
        old_mis = mis_weight(c.pdf0, c.pdf1)
        factor = 0.5 * avdot(normal, view_dir) / dist2
        p0n = c.pdf0 * factor
        p1n = c.pdf1 * factor
        idt_scale = p0n / (p0n + p1n + nee_pdf) / jnp.maximum(old_mis, 1e-30)
        # The rewrite folds the NEE competition into the emission weight
        # (Iterative.comp:252-258); without NEE the carried throughput
        # (mixture-pdf one-sample MIS over the two lobes) is already the
        # full unbiased estimator.
        use_rewrite = ((~miss) & (c.i != 0)) if nee else jnp.zeros_like(miss)
        idt = c.throughput * jnp.where(use_rewrite, idt_scale, 1.0)[..., None]
        contribution = c.contribution + jnp.where(
            c.alive[..., None], idt * emission, 0.0)

        alive = c.alive & ~miss

        # Delta materials (mirror/refractive — MATERIAL_TYPE enum declared
        # but unimplemented in the reference, Material.glsl:15-17).
        if delta:
            mtype = jax.lax.bitcast_convert_type(mrow[:, 10], jnp.int32)
            is_mirror = mtype == 3
            is_glass = mtype == 2
            is_delta = is_mirror | is_glass
        else:
            is_delta = jnp.zeros((nw,), bool)

        # --- NEE (Iterative.comp:272-280) ---
        if nee:
            ls = generate_light_sample(scene, pos, normal, mat, inter,
                                       c.throughput, rnd[:, 0], rnd[:, 1:3],
                                       model, sun=sun, sun_mode=sun_mode,
                                       u_pick=rnd[:, 7])
            # Only trace shadow rays that could contribute: lanes whose
            # light sample is exactly zero (light below the hemisphere,
            # zero BSDF) and delta surfaces (zero BSDF toward any sampled
            # point) read the same 0 whatever the occlusion result, so
            # masking them out of the any-hit trace is EXACT.
            shadow_live = (alive & ~is_delta
                           & jnp.any(ls.throughput * ls.emission != 0.0,
                                     axis=-1))
            rays = rays + jnp.sum(shadow_live, dtype=jnp.int32)
            so, sd, st_ = ls.shadow_origin, ls.shadow_dir, ls.shadow_tmax
            if shadow_rev:
                # Occlusion is segment-symmetric: trace from the LIGHT end
                # toward the surface. Shadow-ray origins then cluster at
                # the emitters (a "light camera"), a more coherent set.
                # Finite segments only (sun rays keep the forward form).
                finite = st_ < 1e19
                so = jnp.where(finite[:, None], so + sd * st_[:, None], so)
                sd = jnp.where(finite[:, None], -sd, sd)
            if partition is not None:
                _, pp_s, _, _ = _ptrace(
                    part_table, part_bounds, so, sd, st_, shadow_live,
                    axis_name=partition_axis, num_devices=num_chips,
                    stack_depth=stack_depth, leaf_size=leaf_size,
                    packet_size=max(packet_size, 128), any_hit=True)
                occluded = pp_s >= 0
            else:
                occluded = trace_occluded(scene, so, sd, st_, shadow_live,
                                          stack_depth=stack_depth,
                                          leaf_size=leaf_size,
                                          traversal=traversal,
                                          packet_size=packet_size)
            contribution = contribution + jnp.where(
                (shadow_live & ~occluded)[..., None],
                ls.throughput * ls.emission, 0.0)

        # --- BSDF sampling + throughput update (Iterative.comp:282-284) ---
        if max_bounces == 0:
            # Pure direct lighting: no path continues past this bounce, so
            # the continuation sample, delta handling, and RR are dead work.
            return Carry(i=c.i + 1, key=key, o=pos, d=c.d,
                         throughput=c.throughput, contribution=contribution,
                         pdf0=c.pdf0, pdf1=c.pdf1, last_pos=pos,
                         alive=jnp.zeros((nw,), bool), rays=rays)

        inter_b, pdf0, pdf1 = generate_importance_sample(
            mat, inter, rnd[:, 3], rnd[:, 4:6], model)
        new_d = inter_b.incoming
        throughput = (c.throughput * compute_bsdf(mat, inter_b, model)
                      * (inter_b.ndi * mis_weight(pdf0, pdf1)
                         / jnp.maximum(pdf0, 1e-30))[..., None])
        new_o = pos

        if delta:
            # Perfect mirror: specular reflection about the geometric normal.
            ndd = jnp.sum(normal * c.d, axis=-1, keepdims=True)
            mir_dir = c.d - 2.0 * ndd * normal
            # Refraction (Snell + Schlick-Fresnel reflect/refract choice).
            ior = mrow[:, 11]
            cosi = -ndd[:, 0]
            entering = cosi >= 0.0
            n_eff = jnp.where(entering[:, None], normal, -normal)
            ci = jnp.abs(cosi)
            eta = jnp.where(entering, 1.0 / ior, ior)
            k = 1.0 - eta * eta * (1.0 - ci * ci)
            tir = k < 0.0
            f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
            fres = f0 + (1.0 - f0) * (1.0 - ci) ** 5
            choose_reflect = tir | (rnd[:, 8] < fres)
            refl_dir = c.d + 2.0 * ci[:, None] * n_eff
            refr_dir = (eta[:, None] * c.d
                        + (eta * ci - jnp.sqrt(jnp.maximum(k, 0.0)))[:, None]
                        * n_eff)
            glass_dir = jnp.where(choose_reflect[:, None], refl_dir, refr_dir)
            transmitted = is_glass & ~choose_reflect

            new_d = jnp.where(is_mirror[:, None], mir_dir,
                              jnp.where(is_glass[:, None], glass_dir, new_d))
            # Delta throughput: albedo tint; the reflect/refract choice is
            # one-sample (weight 1: pdf equals the Fresnel pmf).
            throughput = jnp.where(is_delta[:, None],
                                   c.throughput * mat.albedo, throughput)
            pdf0 = jnp.where(is_delta, 1e8, pdf0)   # delta: emission rewrite
            pdf1 = jnp.where(is_delta, 0.0, pdf1)   # weight -> ~1 next hit
            # Transmitted rays continue on the far side of the surface (pos
            # carries +0.003*normal; step 0.006 across).
            new_o = jnp.where(transmitted[:, None], pos - 0.006 * normal, pos)

        # --- Russian roulette (Iterative.comp:291-300) ---
        continuation = jnp.clip(jnp.max(throughput, axis=-1), 0.0, 1.0)
        throughput = throughput / jnp.maximum(continuation, 1e-12)[..., None]
        kill = (rnd[:, 6] > continuation) | (c.i > max_bounces)
        alive = alive & ~kill

        return Carry(i=c.i + 1, key=key, o=new_o, d=new_d,
                     throughput=throughput, contribution=contribution,
                     pdf0=pdf0, pdf1=pdf1, last_pos=pos, alive=alive,
                     rays=rays)

    # --- Bounce-epoch live-path compaction --------------------------------
    # Role of the persistent-thread refill (Iterative.comp:174-210, 261-300):
    # instead of atomically replacing dead lanes, run the bounce loop at full
    # width only while many paths are alive, then gather survivors into
    # shrinking static buffers. The Russian-roulette tail (a handful of live
    # paths for up to 64 bounces) then pays 1/8- and 1/64-width traversals
    # instead of full-width ones. Unbiased: a phase only ends early once the
    # live count fits the next buffer, and every survivor continues there.
    widths = [n]
    # max_bounces == 0 (pure direct lighting) kills every path at the end
    # of the peeled bounce; without this gate the phase chain would still
    # pay its argsorts and gathers on an all-dead wavefront.
    if compaction and max_bounces > 0:
        for div in compaction_divs:
            wn = max(n // div, compaction_min)
            if wn < widths[-1]:
                widths.append(wn)

    def cap(c: Carry):
        return c.i <= max_bounces + 1

    total = None
    src = None  # compacted lane -> film lane; None while at full width
    # Bounce 0 peeled out of the loop.
    c = body(init)
    for j in range(len(widths)):
        nxt = widths[j + 1] if j + 1 < len(widths) else None
        if nxt is None:
            c = jax.lax.while_loop(lambda c: g_alive_any(c) & cap(c),
                                   body, c)
        else:
            c = jax.lax.while_loop(
                lambda c: (g_alive_max(c) > nxt) & cap(c), body, c)
        # Fold this phase's contributions back into film-lane space.
        if src is None:
            total = c.contribution
        else:
            total = total.at[src].add(c.contribution)
        if nxt is not None:
            order = jnp.argsort(~c.alive, stable=True)[:nxt]  # alive first
            src = order if src is None else src[order]
            c = Carry(i=c.i, key=c.key, o=c.o[order], d=c.d[order],
                      throughput=c.throughput[order],
                      contribution=jnp.zeros((nxt, 3), jnp.float32),
                      pdf0=c.pdf0[order], pdf1=c.pdf1[order],
                      last_pos=c.last_pos[order], alive=c.alive[order],
                      rays=c.rays)
    return total, c.rays


_STATICS = (
    "width", "height", "model", "max_bounces", "stack_depth", "leaf_size",
    "nee", "traversal", "packet_size",
    "textured", "mips", "sun", "sun_mode", "sort_rays", "shadow_rev",
    "delta",
    "compaction", "compaction_divs", "compaction_min", "sampler",
    "partition_axis", "num_chips")

render_sample = partial(jax.jit, static_argnames=_STATICS)(
    render_sample_impl)


@partial(jax.jit, static_argnames=_STATICS + ("spp",))
def render_sample_batch(scene, cam, pixel_x, pixel_y, key, spp: int = 1,
                        sample_idx=0, **statics):
    """spp samples per pixel in ONE dispatch (fori_loop over samples).

    Amortizes the per-dispatch overhead of low-resolution real-time
    frames — the role of the reference presenting every 1-spp dispatch is
    traded for spp/s.
    RNG: sample i uses fold_in(key, i) and LD index sample_idx + i, so a
    batch of spp frames and spp separate frames draw from the same
    per-sample streams (not bitwise-identical to the unbatched path,
    which folds the frame key from the accumulated sample count).
    """
    n = pixel_x.shape[0]

    def body(i, carry):
        acc, rays = carry
        c, r = render_sample_impl(scene, cam, pixel_x, pixel_y,
                                  jax.random.fold_in(key, i),
                                  sample_idx=sample_idx + i, **statics)
        return acc + c, rays + r

    return jax.lax.fori_loop(
        0, spp, body, (jnp.zeros((n, 3), jnp.float32), jnp.int32(0)))
