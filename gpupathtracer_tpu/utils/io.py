"""Image I/O: PNG save/load (role of SOIL2 in the reference) and a native
Radiance .hdr reader for equirectangular environment maps (role of
stb_image's HDR path used at Renderer.cpp:262-317).

PNG is written and read here with zlib alone; Pillow is needed only to read
other formats (JPEG textures).
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples/pixel


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, image: np.ndarray, flip_y: bool = False) -> str:
    """Save an image to an 8-bit RGB PNG.

    `image` is [H, W, 3] float (0..1, clipped) or uint8. The reference y-flips
    saved screenshots (Renderer.cpp:1170-1182); pass flip_y=True for parity.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"save_png expects [H, W, 3], got {arr.shape}")
    if flip_y:
        arr = arr[::-1]
    h, w, _ = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                         axis=1)  # filter type 0 on every scanline
    data = (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters (types 0-4) -> [h, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:   # Sub: running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:   # Up
            cur = (line + prior) & 255
        elif ftype in (3, 4):   # Average / Paeth: sequential along the row
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prior[x])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prior[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def load_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG -> float32 [H, W, 3] in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are "
                         f"supported (depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ctype == 3:
        px = palette[px[..., 0]]
    elif ch in (1, 2):
        px = np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3].astype(np.float32) / 255.0


def load_image(path: str) -> np.ndarray:
    """Load LDR images to float32 [H, W, 3] in [0, 1]; .hdr to linear floats.

    PNG and .hdr need nothing beyond numpy; other formats need Pillow."""
    low = path.lower()
    if low.endswith(".hdr"):
        return load_hdr(path)
    if low.endswith(".png"):
        return load_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {os.path.basename(path)!r} needs Pillow "
                          f"(only PNG and .hdr are read without it)") from e
    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def timestamped_name(prefix: str, suffix: str = ".png") -> str:
    """Timestamped screenshot filename (Program.cpp:127-130 behavior)."""
    return f"{prefix}-{time.strftime('%Y%m%d-%H%M%S')}{suffix}"


def load_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader -> float32 [H, W, 3] linear.

    Supports the common `-Y H +X W` layout with new-style RLE scanlines.
    """
    with open(path, "rb") as f:
        data = f.read()
    # Header ends at the first blank line; next line is the resolution spec.
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution spec {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    for y in range(height):
        # New-style RLE scanline starts with 0x02 0x02 and 16-bit width.
        if (width >= 8 and width < 32768 and buf[pos] == 2 and buf[pos + 1] == 2
                and (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) == width):
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[pos]); pos += 1
                    if count > 128:  # run
                        count -= 128
                        rgbe[y, x:x + count, c] = buf[pos]
                        pos += 1
                    else:            # literal
                        rgbe[y, x:x + count, c] = buf[pos:pos + count]
                        pos += count
                    x += count
        else:  # flat scanline
            flat = buf[pos:pos + width * 4].reshape(width, 4)
            rgbe[y] = flat
            pos += width * 4

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(exponent == 0, 0.0,
                     np.ldexp(1.0, exponent - 136)).astype(np.float32)
    return mantissa * scale[..., None]
