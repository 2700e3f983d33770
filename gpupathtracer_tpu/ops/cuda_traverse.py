"""Per-thread BVH traversal on the GPU: the CUDA kernel of
ops/cuda/traverse.cu, called through `jax.ffi`.

The library is built from the sources in ops/cuda/ with nvcc at first use,
into `cache/native/` keyed by a hash of the sources and the build command.
A failed build raises: there is no fallback to another traversal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.bvh.types import INVALID_ENTRY
from gpupathtracer_tpu.utils.paths import cache_path

TARGET = "gpupathtracer_bvh_traverse"
MAX_STACK_DEPTH = 256
_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                       "traverse.cu")
_registered = False


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA traversal is built with "
                           "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def build_command(source: str, out: str) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", out, source]


def library_path() -> str:
    """Path of the built library (built here first if it is missing)."""
    with open(_SOURCE, "rb") as f:
        src = f.read()
    cmd = build_command(_SOURCE, "OUT")
    digest = hashlib.sha1(src + " ".join(cmd[1:]).encode()).hexdigest()[:16]
    so_path = os.path.join(cache_path("native"),
                           f"libtraverse-{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run(build_command(_SOURCE, tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("building the CUDA traversal failed:\n"
                               + proc.stderr[-4000:])
        os.replace(tmp, so_path)
    return so_path


def register() -> None:
    """Build (if needed), load and register the FFI target, once."""
    global _registered
    if _registered:
        return
    lib = ctypes.CDLL(library_path())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.GptBvhTraverse), platform="CUDA")
    _registered = True


def pack_rays(o, d, t_max, active, root=None):
    """[N, 8] f32 rows (o.xyz, t_max, d.xyz, root entry bit-cast): the
    kernel reads a ray as two 16-byte loads. `root` is a scalar or [N]
    initial stack entry (default 0, the table's root row); inactive lanes
    carry INVALID_ENTRY and are skipped."""
    n = o.shape[0]
    root = jnp.broadcast_to(jnp.asarray(0 if root is None else root,
                                        jnp.int32), (n,))
    entry = jnp.where(active, root, jnp.int32(INVALID_ENTRY))
    return jnp.concatenate(
        [o.astype(jnp.float32), t_max.astype(jnp.float32)[:, None],
         d.astype(jnp.float32),
         jax.lax.bitcast_convert_type(entry, jnp.float32)[:, None]], axis=1)


def _ffi_traverse(rows, rays, *, stack_depth: int, any_hit: bool):
    """The kernel call: ([N, 4] hits, [N] pops)."""
    n = rays.shape[0]
    return jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((n, 4), jnp.float32),
         jax.ShapeDtypeStruct((n,), jnp.int32)))(
        rows, rays, stack_depth=np.int32(stack_depth),
        any_hit=np.int32(any_hit))


def traverse_rows_cuda(rows, o, d, t_max, active, *, stack_depth: int,
                       any_hit: bool, root=None):
    """Trace [N] rays against a merged [M, 128] node/leaf table.

    Returns (t, prim, u, v, pops), each [N]: t_max and prim -1 on a miss;
    pops counts the stack entries each ray popped."""
    if not 1 <= stack_depth <= MAX_STACK_DEPTH:
        raise ValueError(f"stack_depth {stack_depth} outside "
                         f"[1, {MAX_STACK_DEPTH}]")
    register()
    rays = pack_rays(o, d, t_max, active, root)
    hits, pops = _ffi_traverse(rows.astype(jnp.float32), rays,
                               stack_depth=stack_depth, any_hit=any_hit)
    prim = jax.lax.bitcast_convert_type(hits[:, 3], jnp.int32)
    return hits[:, 0], prim, hits[:, 1], hits[:, 2], pops
