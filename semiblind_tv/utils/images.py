"""Test-image loading.

The reference ships 8 grayscale 512² PNGs (`images/`: barbara, boat, bridge,
goldhill, lake, man, mandrill, wheel) plus a 256² cameraman, and the demos
default to wheel.png (run_Gaussian_demo.m:100).  The same public images are
vendored in `data/images/` (see its README for provenance), so a clean
clone reproduces the parity tables out of the box:

  * `load_image(name_or_path)` loads any grayscale PNG — search order is an
    explicit directory argument, then SEMIBLIND_TV_IMAGES, then the
    vendored `data/images/`.
  * `synthetic_wheel(size)` generates a deterministic spoked-wheel
    resolution-chart phantom with the same character (sharp radial edges,
    flat regions, fine detail near the hub) for self-contained runs/tests.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

__all__ = ["load_image", "read_png_gray8", "synthetic_wheel", "available_images"]

_DEFAULT_DIRS = (
    os.environ.get("SEMIBLIND_TV_IMAGES", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "data", "images"),
)


def _search_dirs(image_dir: Optional[str]):
    dirs = [image_dir] if image_dir else []
    dirs += [d for d in _DEFAULT_DIRS if d]
    return [d for d in dirs if os.path.isdir(d)]


def available_images(image_dir: Optional[str] = None):
    names = set()
    for d in _search_dirs(image_dir):
        for f in os.listdir(d):
            if f.lower().endswith(".png"):
                names.add(os.path.splitext(f)[0])
    return sorted(names)


def load_image(name: str, image_dir: Optional[str] = None, size: int = 512) -> np.ndarray:
    """Load a grayscale image as float64 in [0, 255] (MATLAB double(imread))."""
    candidates = []
    if os.path.isfile(name):
        candidates.append(name)
    for d in _search_dirs(image_dir):
        candidates.append(os.path.join(d, name))
        candidates.append(os.path.join(d, name + ".png"))
    for path in candidates:
        if os.path.isfile(path):
            return read_png_gray8(path).astype(np.float64)
    if name in ("wheel", "synthetic", "synthetic_wheel"):
        return synthetic_wheel(size)
    raise FileNotFoundError(
        f"image {name!r} not found; set SEMIBLIND_TV_IMAGES to a directory of "
        f"grayscale PNGs or use the built-in 'wheel' phantom"
    )


def _unfilter_row(ftype: int, line: bytes, prev: list) -> list:
    """Undo one PNG scanline filter (PNG spec §9.2) at 1 byte per pixel."""
    cur = list(line)
    n = len(cur)
    if ftype == 0:
        return cur
    if ftype == 1:  # Sub
        for i in range(1, n):
            cur[i] = (cur[i] + cur[i - 1]) & 0xFF
    elif ftype == 2:  # Up
        cur = [(c + p) & 0xFF for c, p in zip(cur, prev)]
    elif ftype == 3:  # Average
        cur[0] = (cur[0] + (prev[0] >> 1)) & 0xFF
        for i in range(1, n):
            cur[i] = (cur[i] + ((cur[i - 1] + prev[i]) >> 1)) & 0xFF
    elif ftype == 4:  # Paeth
        cur[0] = (cur[0] + prev[0]) & 0xFF
        for i in range(1, n):
            a, b, c = cur[i - 1], prev[i], prev[i - 1]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG filter type {ftype} is not defined")
    return cur


def read_png_gray8(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale, non-interlaced PNG into a (H, W) uint8 array.

    The vendored test images are all of that kind; anything else (colour,
    other bit depths, interlacing) raises ValueError instead of being
    converted."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _comp, _filt, interlace = ihdr
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(
            f"{path}: only 8-bit grayscale non-interlaced PNGs are supported "
            f"(bit depth {depth}, colour type {colour}, interlace {interlace})"
        )
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width + 1):
        raise ValueError(f"{path}: image data has {len(raw)} bytes, "
                         f"expected {height * (width + 1)}")
    rows, prev = [], [0] * width
    for r in range(height):
        start = r * (width + 1)
        prev = _unfilter_row(raw[start], raw[start + 1:start + 1 + width], prev)
        rows.append(prev)
    return np.asarray(rows, dtype=np.uint8)


def synthetic_wheel(size: int = 512, n_spokes: int = 36, soften: float = 1.2) -> np.ndarray:
    """Deterministic spoked-wheel resolution phantom in [0, 255].

    `soften` applies a mild optical-softness blur (std in absolute pixels —
    the 7×7 PSF is size-independent) plus low-amplitude deterministic texture so the
    phantom's gradient statistics resemble a *photographed* chart (like the
    reference's wheel.png) rather than a binary mask.  Razor-sharp binary
    edges are adversarial for semi-blind PSF estimation — the posterior
    stays sharp and the kernel-width gradient biases toward no-blur — which
    is an image-property, not an implementation property (pass soften=0 to
    reproduce it).
    """
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size]
    dx, dy = xx - c, yy - c
    r = np.hypot(dx, dy)
    ang = np.arctan2(dy, dx)
    spokes = 0.5 * (1.0 + np.sign(np.sin(n_spokes * ang)))
    img = spokes.copy()
    rim_outer = 0.47 * size
    rim_inner = 0.43 * size
    img[(r <= rim_outer) & (r >= rim_inner)] = 1.0
    img[r > rim_outer] = 0.0
    hub = 0.06 * size
    img[r < hub] = 1.0
    img[r < 0.5 * hub] = 0.0
    if soften > 0:
        from scipy.ndimage import gaussian_filter

        img = gaussian_filter(img, soften, mode="wrap")
        # deterministic low-amplitude texture (smooth harmonics)
        tex = 0.04 * (
            np.sin(2 * np.pi * 7 * xx / size) * np.sin(2 * np.pi * 5 * yy / size)
            + 0.5 * np.sin(2 * np.pi * 13 * (xx + yy) / size)
        )
        img = np.clip(img + tex, 0.0, 1.0)
    return (255.0 * img).astype(np.float64)
