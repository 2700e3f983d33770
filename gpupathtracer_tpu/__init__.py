"""gpupathtracer_tpu — a progressive path tracer in JAX for NVIDIA GPUs.

A from-scratch JAX rebuild of the capabilities of saadam1n/GPUPathTracer
("OpenGL Light Transport"): scene ingest (OBJ/MTL, glTF, procedural), SBVH
construction flattened to a wide (8-ary) layout, wavefront path tracing
(thin-lens DoF, NEE + MIS, Cook-Torrance microfacet BSDFs, Russian
roulette), progressive accumulation, filmic tonemapping, and multi-device
sample sharding over a `jax.sharding.Mesh`.

The reference is a single-GPU OpenGL compute megakernel; this package keeps
its per-thread BVH traversal as a CUDA kernel (ops/cuda/traverse.cu) and
runs the rest as fixed-shape SoA wavefronts: `lax.while_loop` bounded bounce
loops, counter-based threefry RNG (reproducible renders on one backend), and
`shard_map`/`psum` instead of atomics.
"""

__version__ = "0.1.0"

from gpupathtracer_tpu.config import RenderConfig, CameraConfig, load_scene_txt

__all__ = ["RenderConfig", "CameraConfig", "load_scene_txt", "__version__"]
