"""Image-grid and GIF writers (``graphical_gan_tpu/report/save_images.py``,
``tflib/save_images.py``).

The montage math is the JAX package's: a square-ish grid (the largest
divisor of N that is at most sqrt(N) rows) or an explicit ``size=(rows,
cols)``; floats in [0, 1] scale by 255.99; BCHW input turns BHWC; 2-D input
reshapes to square images. ``save_images`` writes the PNG itself (8-bit
gray or RGB, filter 0 on every row, one zlib IDAT chunk), so it needs no
PIL. ``save_gifs`` needs imageio, imported where it runs.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _grid_shape(n_samples: int, size) -> Tuple[int, int]:
    if size is None:
        rows = int(np.sqrt(n_samples))
        while n_samples % rows != 0:
            rows -= 1
        return rows, n_samples // rows
    nh, nw = int(size[0]), int(size[1])
    if nh * nw != n_samples:
        raise ValueError(f"a {nh}x{nw} grid does not hold {n_samples} images")
    return nh, nw


def large_image(x: np.ndarray, size=None) -> np.ndarray:
    """Montage of N images into one (H*nh, W*nw[, 3]) uint8 array."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        x = (255.99 * x).astype("uint8")
    n = x.shape[0]
    nh, nw = _grid_shape(n, size)

    if x.ndim == 2:
        side = int(np.sqrt(x.shape[1]))
        x = x.reshape(n, side, side)
    if x.ndim == 4:
        if x.shape[1] in (1, 3) and x.shape[1] < x.shape[-1]:
            x = x.transpose(0, 2, 3, 1)  # BCHW -> BHWC
        if x.shape[-1] == 1:
            x = x[..., 0]

    h, w = x.shape[1:3]
    if x.ndim == 4:
        img = np.zeros((h * nh, w * nw, 3), dtype=np.uint8)
    else:
        img = np.zeros((h * nh, w * nw), dtype=np.uint8)
    for k in range(n):
        j, i = divmod(k, nw)
        img[j * h:(j + 1) * h, i * w:(i + 1) * w] = x[k]
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W] (gray) or [H, W, 3] (RGB) array."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 3], not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    # bit depth 8, the color type, deflate, adaptive filtering, no interlace
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def png_size(path: str) -> Tuple[int, int, int]:
    """(width, height, color type) from a PNG file's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    w, h, _, color = struct.unpack(">IIBB", head[16:26])
    return w, h, color


def save_images(x: np.ndarray, save_path: str, size=None) -> str:
    with open(save_path, "wb") as f:
        f.write(encode_png(large_image(np.asarray(x), size=size)))
    return save_path


def save_gifs(x: np.ndarray, save_path: str, size=None, fps: int = 5) -> str:
    """x: [N, T, C, H, W]: one montage frame per timestep
    (``tflib/save_images.py:47-51``)."""
    import imageio
    frames = [large_image(x[:, t], size=size) for t in range(x.shape[1])]
    imageio.mimsave(save_path, frames, duration=1.0 / fps)
    return save_path
