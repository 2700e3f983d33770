"""Environment maps.

The reference supports three skybox specs (src/core/Renderer.cpp:236-325):
  1. "GENERATE COLOR WHITE|BLACK" -> 1x1 cubemap,
  2. *.hdr/*.jpg equirectangular -> 1024^2 cubemap via an FBO raster pass,
  3. a txt file listing 6 face images.

TPU-native redesign: everything becomes ONE representation — an
equirectangular lat-long image sampled directly by direction (bilinear).
Constant colors are a 2x4 image; 6-face cubemaps are resampled to equirect
once at load (numpy, init-time). This removes the GPU raster pass and gives
the integrator a single gather-based sampling path.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from gpupathtracer_tpu.utils.io import load_image


class EnvMap(NamedTuple):
    """Lat-long radiance map. Pytree-compatible (single jnp array)."""

    image: jnp.ndarray  # [H, W, 3] float32, linear radiance


def from_color(rgb) -> EnvMap:
    img = np.broadcast_to(np.asarray(rgb, np.float32), (2, 4, 3)).copy()
    return EnvMap(image=jnp.asarray(img))


def from_equirect(img: np.ndarray) -> EnvMap:
    return EnvMap(image=jnp.asarray(np.ascontiguousarray(img, np.float32)))


def dir_to_equirect_uv(d):
    """Direction -> lat-long uv, matching EquirectangularConverter.frag:9-16:
    uv = (atan(z, x) * 0.1591, asin(y) * 0.3183) + 0.5."""
    u = jnp.arctan2(d[..., 2], d[..., 0]) * 0.15915494 + 0.5
    v = jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0)) * 0.31830987 + 0.5
    return u, v


def sample_env(env: EnvMap, directions) -> jnp.ndarray:
    """Bilinear lat-long lookup for unit `directions` [..., 3] -> [..., 3]."""
    img = env.image
    h, w = img.shape[0], img.shape[1]
    if h == 1 and w == 1:
        # GENERATE COLOR environments are a 1x1 map: skip the 4 bilinear
        # gathers (full-width, every bounce) and broadcast.
        return jnp.broadcast_to(img[0, 0], directions.shape)
    u, v = dir_to_equirect_uv(directions)
    # v=0 is the bottom (asin(-1)); image row 0 is stored as the bottom row.
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = jnp.mod(x0.astype(jnp.int32), w)        # wrap in longitude
    xi1 = jnp.mod(xi0 + 1, w)
    yi = y0.astype(jnp.int32)
    yi0 = jnp.clip(yi, 0, h - 1)        # clamp in latitude
    yi1 = jnp.clip(yi + 1, 0, h - 1)
    c00 = img[yi0, xi0]
    c01 = img[yi0, xi1]
    c10 = img[yi1, xi0]
    c11 = img[yi1, xi1]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def _cubemap_to_equirect(faces: np.ndarray, out_h: int = 512) -> np.ndarray:
    """Resample 6 cube faces [6, S, S, 3] (GL +X,-X,+Y,-Y,+Z,-Z order) to a
    lat-long image (nearest; done once at load)."""
    out_w = out_h * 2
    v = (np.arange(out_h) + 0.5) / out_h
    u = (np.arange(out_w) + 0.5) / out_w
    uu, vv = np.meshgrid(u, v)
    phi = (uu - 0.5) / 0.15915494
    theta = (vv - 0.5) / 0.31830987
    d = np.stack([np.cos(theta) * np.cos(phi), np.sin(theta),
                  np.cos(theta) * np.sin(phi)], axis=-1)
    ax, ay, az = np.abs(d[..., 0]), np.abs(d[..., 1]), np.abs(d[..., 2])
    # Standard GL cubemap face selection + (s,t) derivation.
    face = np.where(ax >= np.maximum(ay, az),
                    np.where(d[..., 0] > 0, 0, 1),
                    np.where(ay >= az, np.where(d[..., 1] > 0, 2, 3),
                             np.where(d[..., 2] > 0, 4, 5)))
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    sc = np.choose(face, [-z, z, x, x, x, -x])
    tc = np.choose(face, [-y, -y, z, -z, -y, -y])
    ma = np.choose(face, [ax, ax, ay, ay, az, az])
    s = (sc / np.maximum(ma, 1e-9) + 1.0) / 2.0
    t = (tc / np.maximum(ma, 1e-9) + 1.0) / 2.0
    size = faces.shape[1]
    si = np.clip((s * size).astype(np.int64), 0, size - 1)
    ti = np.clip((t * size).astype(np.int64), 0, size - 1)
    return faces[face, ti, si].astype(np.float32)


def load_environment(spec: str, base_dir: str = ".") -> EnvMap:
    """Dispatch on the skybox spec string (Renderer.cpp:238-318 grammar)."""
    spec = spec.strip()
    if spec.startswith("GENERATE"):
        parts = spec.split()
        if len(parts) >= 3 and parts[1] == "COLOR":
            if len(parts) >= 5:
                try:  # numeric "GENERATE COLOR r g b" (beyond the reference)
                    return from_color(tuple(float(x) for x in parts[2:5]))
                except ValueError:
                    pass
            color = {"WHITE": (1.0, 1.0, 1.0), "BLACK": (0.0, 0.0, 0.0)}.get(
                parts[2], (1.0, 0.0, 0.0))  # RED for error, like the reference
            return from_color(color)
        return from_color((1.0, 0.0, 0.0))
    path = spec if os.path.isabs(spec) else os.path.join(base_dir, spec)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".hdr", ".jpg", ".jpeg", ".png", ".exr"):
        img = load_image(path)
        # Our equirect convention stores row 0 at the bottom (v=0 <-> y=-1);
        # image files store row 0 at the top, so flip.
        return from_equirect(img[::-1])
    if ext == ".txt":
        with open(path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        folder = os.path.dirname(path)
        faces = np.stack([load_image(os.path.join(folder, n)) for n in names[:6]])
        return from_equirect(_cubemap_to_equirect(faces))
    raise ValueError(f"unrecognized skybox spec {spec!r}")
