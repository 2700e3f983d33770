"""Multi-chip rendering over a jax.sharding.Mesh.

The reference is single-GPU; its only "collectives" are one atomicAdd ray
counter and memory barriers (SURVEY.md §2.5). The scaling story here:

  - the *scene* (triangles, BVH, materials, env) is replicated per chip;
  - the *pixel space* is sharded over the mesh axis "pixels" (each chip owns
    a contiguous slice of the Morton-ordered ray space);
  - the *sample space* is sharded over the mesh axis "samples" (each chip
    renders an independent threefry stream of the same pixels);
  - per-pixel radiance is `psum`ed over the samples axis — the one
    collective — and the per-frame ray counter is `psum`ed over the whole
    mesh.

One sharded frame therefore accumulates `samples_axis` spp. The mesh shape
follows the algorithm alone: four cards joined all to all take (4,) or
(2, 2) equally well, and both compile on a CPU-device mesh for testing
(tests/test_sharding.py).

Multi-host: map "pixels" to the cross-host dimension — radiance is psum'ed
over "samples" only, so no film bytes ever cross hosts (the single
pixels-axis collective is the scalar ray counter). Pinned at HLO level by
tests/test_sharding.py::test_pixels_axis_radiance_stays_local. On several
hosts: jax.distributed.initialize(), then
make_device_mesh((samples_per_host, num_hosts)).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from gpupathtracer_tpu.models.wavefront import render_sample_impl


def make_device_mesh(shape: Sequence[int],
                     devices: Optional[Sequence] = None) -> Mesh:
    """Create a ("samples", "pixels") mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(tuple(shape))
    return Mesh(arr, axis_names=("samples", "pixels")[-len(shape):])


def render_sample_sharded(mesh: Mesh, scene, cam, pixel_x, pixel_y, key,
                          sample_base=0,
                          **static) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Render one multi-chip frame.

    pixel_x/pixel_y are the FULL ray-ordered pixel arrays [N]; N must divide
    evenly by the "pixels" axis size. sample_base is the frame's first
    global sample index (each samples-axis device renders sample_base +
    its axis position — the LD sampler needs distinct indices). Returns
    ([N, 3] radiance summed over the samples axis, scalar rays traced
    across the mesh). Callers treat the result as `samples_axis_size`
    accumulated samples.
    """
    axis_names = mesh.axis_names
    has_samples = "samples" in axis_names
    pixel_spec = P("pixels") if "pixels" in axis_names else P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), pixel_spec, pixel_spec, P(), P()),
             out_specs=(pixel_spec, P()),
             check_vma=False)
    def step(scene, cam, px, py, key, sample_base):
        sidx = sample_base
        if has_samples:
            sample_idx = jax.lax.axis_index("samples")
            key = jax.random.fold_in(key, sample_idx)
            sidx = sample_base + sample_idx
        if "pixels" in axis_names:
            key = jax.random.fold_in(key, jax.lax.axis_index("pixels") + 1311)
        contribution, rays = render_sample_impl(scene, cam, px, py, key,
                                                sample_idx=sidx, **static)
        if has_samples:
            contribution = jax.lax.psum(contribution, "samples")
            rays = jax.lax.psum(rays, "samples")
        if "pixels" in axis_names:
            rays = jax.lax.psum(rays, "pixels")
        return contribution, rays

    return step(scene, cam, pixel_x, pixel_y, key,
                jnp.asarray(sample_base, jnp.int32))
