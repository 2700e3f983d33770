"""Progressive renderer: frame orchestration.

Role of src/core/Renderer.{h,cpp}: initialize (scene + BVH + film), render
one sample per pixel per frame into an accumulation buffer, present
(tonemap), reset on camera move, save screenshots, and run the ground-truth
reference integrator.

Redesign: the accumulation buffer lives on device in *Morton ray order*
(the reference permutes pixel order on the fly, Iterative.comp:163-172; we
bake the permutation once and unpermute only at present time). The film is
padded to 8x8-aligned dimensions and cropped on present. The film is
processed in fixed-size chunks — the static-shape replacement for the
megakernel's atomic ray pool.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.config import RenderConfig
from gpupathtracer_tpu.math.camera import CameraParams, generate_image_plane
from gpupathtracer_tpu.models.reference import render_sample_reference
from gpupathtracer_tpu.models.wavefront import render_sample
from gpupathtracer_tpu.ops.tonemap import present as present_op
from gpupathtracer_tpu.utils.io import save_png
from gpupathtracer_tpu.utils.morton import ray_order
from gpupathtracer_tpu.utils.timing import FrameStats, Timer


def _align8(x: int) -> int:
    return (x + 7) // 8 * 8


class Renderer:
    def __init__(self, cfg: RenderConfig, scene=None, meta=None) -> None:
        self.cfg = cfg
        if scene is None:
            from gpupathtracer_tpu.scene import load_scene
            scene, meta = load_scene(cfg)
        self.scene = scene
        self.meta = meta
        self.width, self.height = cfg.width, cfg.height
        self.pad_w, self.pad_h = _align8(cfg.width), _align8(cfg.height)
        n = self.pad_w * self.pad_h

        # Multi-chip: samples/pixels sharded over a device mesh
        # (parallel/mesh.py). One sharded frame accumulates
        # `samples_axis_size` spp.
        self.mesh = None
        self.samples_per_frame = 1
        self.partition = None
        pixels_axis = 1
        if cfg.partition_chips > 0:
            # Scene-PARTITIONED mesh (parallel/partition.py): devices own
            # compacted BVH subtrees (hot ones replicated into hop-0
            # roots), rays migrate between them; optional sample replicas
            # compose on top. The distributed-memory alternative to the
            # replicated mesh below.
            if int(np.prod(cfg.mesh_shape)) > 1:
                raise ValueError("partition_chips and mesh_shape are "
                                 "mutually exclusive scaling modes")
            from jax.sharding import Mesh as _Mesh

            from gpupathtracer_tpu.bvh.partition import build_partition
            from gpupathtracer_tpu.parallel.partition import shard_partition
            C, S = cfg.partition_chips, max(cfg.partition_samples, 1)
            devs = jax.devices()
            if S * C > len(devs):
                raise ValueError(
                    f"partition mesh ({S} samples x {C} chips) needs "
                    f"{S * C} devices, have {len(devs)}")
            arr = np.asarray(devs[:S * C])
            if S > 1:
                self.mesh = _Mesh(arr.reshape(S, C),
                                  axis_names=("samples", "chips"))
            else:
                self.mesh = _Mesh(arr.reshape(C), axis_names=("chips",))
            if scene.bvh.child_entry.shape[1] != 8 or cfg.leaf_size > 10:
                raise ValueError("partition_chips requires wide_arity=8 and "
                                 "leaf_size <= 10 (the partition builder "
                                 "parses 8-wide single-row-leaf tables)")
            part = build_partition(np.asarray(scene.bvh.node_rows),
                                   scene.bvh.child_bounds.shape[0], C)
            self.partition = shard_partition(part, self.mesh)
            self.samples_per_frame = S
            pixels_axis = C
        elif int(np.prod(cfg.mesh_shape)) > 1:
            from gpupathtracer_tpu.parallel import make_device_mesh
            self.mesh = make_device_mesh(cfg.mesh_shape)
            sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
            pixels_axis = sizes.get("pixels", 1)
            self.samples_per_frame = sizes.get("samples", 1)

        # Ray order: Morton/Hilbert within 8x8 blocks (Renderer.cpp:568-592).
        # Films that don't divide the mesh's pixels axis are padded with
        # sentinel rays whose contributions land in an extra film slot that
        # present()/film_hdr() drop.
        fwd = ray_order(self.pad_w, self.pad_h, cfg.pixel_order)
        pad_rays = (-n) % pixels_axis
        if pad_rays:
            fwd = np.concatenate([fwd, np.full(pad_rays, n, fwd.dtype)])
        self._ray_to_pixel = jnp.asarray(fwd)
        px = np.where(fwd < n, fwd % self.pad_w, 0)
        py = np.where(fwd < n, fwd // self.pad_w, 0)
        self.pixel_x = jnp.asarray(px.astype(np.float32))
        self.pixel_y = jnp.asarray(py.astype(np.float32))
        self.n_rays = n + pad_rays

        # Fewest equal chunks <= ray_chunk that tile the ray space exactly:
        # every chunk is one jit dispatch, so chunk count — not chunk
        # alignment — is what matters.
        n_chunks = max(-(-self.n_rays // min(cfg.ray_chunk, self.n_rays)), 1)
        while self.n_rays % n_chunks:
            n_chunks += 1
        self.chunk = self.n_rays // n_chunks

        # Resolve the traversal once against the active backend.
        from gpupathtracer_tpu.ops.traverse import resolve_traversal
        self.traversal = resolve_traversal(cfg.traversal)

        self.accum = jnp.zeros((self.n_rays, 3), jnp.float32)
        self.num_samples = 0
        self.base_key = jax.random.PRNGKey(cfg.seed)
        self.camera: CameraParams = generate_image_plane(cfg.camera)
        self.stats = FrameStats()

    # -- frame loop ---------------------------------------------------------

    def set_camera(self, camera_cfg) -> None:
        """Camera moved: regenerate basis and reset accumulation
        (Program.cpp:115-120 behavior)."""
        self.cfg.camera = camera_cfg
        self.camera = generate_image_plane(camera_cfg)
        self.reset_samples()

    def render_frame(self, integrator: Optional[str] = None,
                     sync: bool = False) -> None:
        """Accumulate one sample per pixel (RenderFrame, Renderer.cpp:651-662).

        Asynchronous by default: the frame only enqueues device work and
        its ray counter stays on the device (drained lazily by FrameStats).
        Pass sync=True (or call .sync()) to wait for completion — the
        frame's recorded time then covers the whole drained pipeline, so
        timing k async frames + 1 sync frame stays honest in total.
        """
        integrator = integrator or self.cfg.integrator
        timer = Timer(); timer.begin()
        sample_key = jax.random.fold_in(self.base_key, self.num_samples)
        if self.mesh is not None and integrator == "wavefront":
            contribution, rays = self._render_sharded(sample_key)
            self.accum = self.accum + contribution
            self.num_samples += self.samples_per_frame
        else:
            batch = (self.cfg.frame_batch
                     if integrator in ("wavefront", "direct") else 1)
            out, rays = [], jnp.int32(0)
            for c0 in range(0, self.n_rays, self.chunk):
                key = jax.random.fold_in(sample_key, c0 // self.chunk)
                sl = slice(c0, c0 + self.chunk)
                contribution, r = self._render_chunk(integrator, sl, key,
                                                     batch)
                out.append(contribution)
                rays = rays + r
            contribution = (out[0] if len(out) == 1
                            else jnp.concatenate(out, axis=0))
            self.accum = self.accum + contribution
            self.num_samples += batch
        if sync:
            self.sync()
        self.stats.add_frame(timer.end(), rays)

    def sync(self) -> None:
        """Wait for every enqueued frame to finish on the device."""
        jax.block_until_ready(self.accum)

    def _render_sharded(self, key):
        """One mesh-sharded frame = samples_per_frame spp (parallel/mesh.py),
        or the scene-partitioned step when cfg.partition_chips > 0."""
        if self.partition is not None:
            from gpupathtracer_tpu.parallel.partition import \
                render_sample_partitioned
            tables, route = self.partition
            return render_sample_partitioned(
                self.mesh, tables, route, self.scene, self.camera,
                self.pixel_x, self.pixel_y, key,
                sample_base=self.num_samples,
                sampler=self.cfg.sampler,
                compaction=self.cfg.compaction,
                compaction_divs=tuple(self.cfg.compaction_divs),
                width=self.pad_w, height=self.pad_h,
                max_bounces=self.cfg.max_bounces,
                stack_depth=self.meta.stack_depth,
                leaf_size=self.meta.leaf_size, model=self.cfg.microfacet,
                packet_size=self.cfg.packet_size,
                textured=self.meta.has_textures,
                mips=self.meta.mip_levels > 1, sun=self.cfg.sun_enabled,
                sun_mode=self.cfg.sun_mode, nee=self.cfg.nee_enabled,
                partition_routing=self.cfg.partition_routing,
                delta=getattr(self.meta, "has_delta", False))
        from gpupathtracer_tpu.parallel import render_sample_sharded
        return render_sample_sharded(
            self.mesh, self.scene, self.camera, self.pixel_x, self.pixel_y,
            key, sample_base=self.num_samples,
            sampler=self.cfg.sampler,
            shadow_rev=self.cfg.shadow_rev,
            compaction=self.cfg.compaction,
            compaction_divs=tuple(self.cfg.compaction_divs),
            width=self.pad_w, height=self.pad_h,
            max_bounces=self.cfg.max_bounces,
            stack_depth=self.meta.stack_depth,
            leaf_size=self.meta.leaf_size, model=self.cfg.microfacet,
            traversal=self.traversal,
            packet_size=min(self.cfg.packet_size, self.chunk),
            textured=self.meta.has_textures,
            mips=self.meta.mip_levels > 1, sun=self.cfg.sun_enabled,
            sun_mode=self.cfg.sun_mode, nee=self.cfg.nee_enabled,
            delta=getattr(self.meta, "has_delta", False))

    def _render_chunk(self, integrator: str, sl: slice, key, batch: int = 1):
        """Returns ([C,3] contribution, rays traced). batch > 1 renders
        that many samples in one dispatch (render_sample_batch)."""
        px = self.pixel_x[sl]
        py = self.pixel_y[sl]
        kwargs = dict(width=self.pad_w, height=self.pad_h,
                      max_bounces=self.cfg.max_bounces,
                      compaction=self.cfg.compaction,
                      compaction_divs=tuple(self.cfg.compaction_divs),
                      stack_depth=self.meta.stack_depth,
                      leaf_size=self.meta.leaf_size,
                      model=self.cfg.microfacet,
                      traversal=self.traversal,
                      packet_size=min(self.cfg.packet_size, self.chunk),
                      textured=self.meta.has_textures,
                      mips=self.meta.mip_levels > 1,
                      sun=self.cfg.sun_enabled,
                      sun_mode=self.cfg.sun_mode,
                      delta=getattr(self.meta, "has_delta", False))
        if integrator == "wavefront":
            if batch > 1:
                from gpupathtracer_tpu.models.wavefront import \
                    render_sample_batch
                return render_sample_batch(
                    self.scene, self.camera, px, py, key, spp=batch,
                    nee=self.cfg.nee_enabled, sort_rays=self.cfg.sort_rays,
                    shadow_rev=self.cfg.shadow_rev,
                    sampler=self.cfg.sampler,
                    sample_idx=self.num_samples, **kwargs)
            return render_sample(self.scene, self.camera, px, py, key,
                                 nee=self.cfg.nee_enabled,
                                 sort_rays=self.cfg.sort_rays,
                                 shadow_rev=self.cfg.shadow_rev,
                                 sampler=self.cfg.sampler,
                                 sample_idx=self.num_samples, **kwargs)
        if integrator == "direct":
            # Real-time mode (BASELINE config 3): primary hit + emitter
            # visibility + NEE shadow rays; no continuation wavefront.
            kwargs["max_bounces"] = 0
            if batch > 1:
                from gpupathtracer_tpu.models.wavefront import \
                    render_sample_batch
                return render_sample_batch(
                    self.scene, self.camera, px, py, key, spp=batch,
                    nee=True, sampler=self.cfg.sampler,
                    shadow_rev=self.cfg.shadow_rev,
                    sample_idx=self.num_samples, **kwargs)
            return render_sample(self.scene, self.camera, px, py, key,
                                 nee=True, sampler=self.cfg.sampler,
                                 shadow_rev=self.cfg.shadow_rev,
                                 sample_idx=self.num_samples, **kwargs)
        if integrator == "reference":
            kwargs.pop("delta", None)  # reference integrator: diffuse only
            kwargs.pop("sun_mode", None)  # reference: sun-on-miss only
            kwargs.pop("compaction", None)
            kwargs.pop("compaction_divs", None)
            kwargs.pop("mips", None)  # reference samples level 0 only
            out = render_sample_reference(self.scene, self.camera, px, py,
                                          key, **kwargs)
            return out, self.chunk
        if integrator == "ao":
            from gpupathtracer_tpu.models.ao import render_sample_ao
            for k in ("max_bounces", "model", "textured", "mips", "sun",
                      "delta", "sun_mode", "compaction", "compaction_divs"):
                kwargs.pop(k, None)
            return render_sample_ao(self.scene, self.camera, px, py, key,
                                    **kwargs)
        raise ValueError(f"unknown integrator {integrator!r}")

    def reset_samples(self) -> None:
        """ResetSamples (Renderer.cpp:687-691)."""
        self.accum = jnp.zeros_like(self.accum)
        self.num_samples = 0

    # -- output ---------------------------------------------------------------

    def _unpermute(self):
        """Accumulator (ray order) -> film pixel order; the +1 slot absorbs
        sentinel padding rays from non-dividing mesh pixel axes."""
        flat = jnp.zeros((self.pad_h * self.pad_w + 1, 3), jnp.float32)
        flat = flat.at[self._ray_to_pixel].set(self.accum)
        return flat[:self.pad_h * self.pad_w]

    def film_hdr(self) -> np.ndarray:
        """Mean radiance per pixel, [H, W, 3] float32 (pre-tonemap)."""
        img = np.asarray(self._unpermute()).reshape(self.pad_h, self.pad_w, 3)
        img = img[:self.height, :self.width]
        return img / max(self.num_samples, 1)

    def present_device(self):
        """Tonemapped LDR frame as a DEVICE array (no host readback).

        Lets a caller enqueue the next frame's dispatch before paying the
        transfer — the double-buffering a windowed renderer gets from the
        swapchain (Program.cpp's render/Present overlap). Convert with
        np.asarray when the pixels are actually needed."""
        img = present_op(self._unpermute().reshape(self.pad_h, self.pad_w, 3),
                         max(self.num_samples, 1),
                         exposure=self.cfg.exposure,
                         tonemap=self.cfg.tonemap)
        return img[:self.height, :self.width]

    def present(self) -> np.ndarray:
        """Tonemapped LDR frame [H, W, 3] in [0, 1] (Present.frag role).
        Row 0 is the bottom scanline (GL convention); save with flip_y=True."""
        return np.asarray(self.present_device())

    def save_screenshot(self, path: str) -> str:
        """SaveScreenshot (Renderer.cpp:697-705): tonemapped PNG, y-flipped."""
        return save_png(path, self.present(), flip_y=True)

    def render(self, spp: int, integrator: Optional[str] = None,
               verbose: bool = False) -> np.ndarray:
        """Convenience: accumulate `spp` samples and return the LDR frame."""
        for s in range(spp):
            self.render_frame(integrator)
            if verbose and (s + 1) % max(spp // 10, 1) == 0:
                print(f"  sample {s + 1}/{spp} ({self.stats.avg_fps:.2f} fps)")
        return self.present()
