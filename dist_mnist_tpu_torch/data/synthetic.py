"""Deterministic procedural datasets (a copy of the reference's
`data/synthetic.py`, which imports no JAX; a test pins the two
byte-identical).

Training needs no download: every named dataset has a procedural twin
with the same shapes/dtypes and enough class structure that the real
models train to high accuracy on it. Generation is fully vectorized
numpy, seeded with Philox counters, so any (seed, split) pair is bitwise
reproducible across hosts.

Digits are rendered from an embedded 5x7 font through a random affine warp
(shift / rotate / scale / shear) with bilinear sampling plus pixel noise —
i.e. a miniature, self-contained MNIST generator.
"""

from __future__ import annotations

import numpy as np

# 5x7 digit glyphs (rows are strings; '#' = ink). Classic LCD-ish font.
_DIGIT_GLYPHS = [
    [" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "],  # 0
    ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],  # 1
    [" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"],  # 2
    [" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "],  # 3
    ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],  # 4
    ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],  # 5
    [" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "],  # 6
    ["#####", "    #", "   # ", "  #  ", "  #  ", " #   ", " #   "],  # 7
    [" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "],  # 8
    [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],  # 9
]

# 10 abstract garment-ish silhouettes for the fashion twin: coarse 5x7 masks.
_FASHION_GLYPHS = [
    ["#####", "#####", "#####", "#####", "#####", "#####", "#####"],  # block
    ["  #  ", " ### ", " ### ", " ### ", " ### ", " ### ", "  #  "],  # column
    ["#   #", "## ##", "#####", " ### ", " ### ", " ### ", " ### "],  # shirt
    [" ### ", " ### ", "  #  ", " ### ", "#####", "#####", "#####"],  # dress
    ["#####", "#   #", "#   #", "#   #", "#   #", "#   #", "#####"],  # frame
    ["#### ", "#####", "   ##", "  ## ", " ##  ", "##   ", "#####"],  # sandal?
    ["#    ", "##   ", "###  ", "#### ", "#####", "#### ", "###  "],  # wedge
    [" # # ", " # # ", " # # ", " # # ", " # # ", " # # ", " # # "],  # trouser
    ["  ## ", " ####", "#####", "#####", "## ##", "#   #", "##  #"],  # bag
    ["###  ", "###  ", "###  ", "###  ", "#####", "#####", " ####"],  # boot
]


def _glyph_canvases(glyphs: list[list[str]], canvas: int = 20) -> np.ndarray:
    """(10, canvas, canvas) float32 glyph images, nearest-upscaled, blurred."""
    out = np.zeros((len(glyphs), canvas, canvas), np.float32)
    for i, g in enumerate(glyphs):
        bitmap = np.array(
            [[1.0 if ch == "#" else 0.0 for ch in row] for row in g], np.float32
        )
        # nearest-neighbour upscale 5x7 -> canvas x canvas (aspect stretched)
        ys = np.clip((np.arange(canvas) * bitmap.shape[0]) // canvas, 0, 6)
        xs = np.clip((np.arange(canvas) * bitmap.shape[1]) // canvas, 0, 4)
        img = bitmap[np.ix_(ys, xs)]
        # 3x3 box blur for soft edges (ink spread like anti-aliased pen)
        padded = np.pad(img, 1)
        img = sum(
            padded[dy : dy + canvas, dx : dx + canvas]
            for dy in range(3)
            for dx in range(3)
        ) / 9.0
        out[i] = img
    return out


def _random_affine(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 2, 3) inverse affine maps: output pixel -> glyph-canvas coords."""
    angle = rng.uniform(-0.25, 0.25, n)  # radians, ~±14°
    scale = rng.uniform(0.75, 1.1, n)
    shear = rng.uniform(-0.15, 0.15, n)
    tx = rng.uniform(-3.0, 3.0, n)
    ty = rng.uniform(-3.0, 3.0, n)
    ca, sa = np.cos(angle) / scale, np.sin(angle) / scale
    mats = np.zeros((n, 2, 3), np.float32)
    mats[:, 0, 0] = ca
    mats[:, 0, 1] = sa + shear
    mats[:, 1, 0] = -sa
    mats[:, 1, 1] = ca
    mats[:, 0, 2] = tx
    mats[:, 1, 2] = ty
    return mats


def _render(
    glyphs: np.ndarray, labels: np.ndarray, rng: np.random.Generator, size: int = 28
) -> np.ndarray:
    """Warp each sample's glyph into a size x size image. Vectorized bilinear."""
    n = labels.shape[0]
    canvas = glyphs.shape[1]
    mats = _random_affine(rng, n)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    # center both frames, then apply per-sample inverse map
    oy = yy.ravel().astype(np.float32) - (size - 1) / 2
    ox = xx.ravel().astype(np.float32) - (size - 1) / 2
    coords = np.stack([oy, ox, np.ones_like(ox)])  # (3, P)
    src = mats @ coords  # (n, 2, P)
    sy = src[:, 0] + (canvas - 1) / 2
    sx = src[:, 1] + (canvas - 1) / 2
    y0 = np.floor(sy).astype(np.int32)
    x0 = np.floor(sx).astype(np.int32)
    wy = sy - y0
    wx = sx - x0
    imgs = glyphs[labels]  # (n, canvas, canvas)
    flat = imgs.reshape(n, -1)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < canvas) & (xi >= 0) & (xi < canvas)
        idx = np.clip(yi, 0, canvas - 1) * canvas + np.clip(xi, 0, canvas - 1)
        return np.take_along_axis(flat, idx, axis=1) * valid

    val = (
        gather(y0, x0) * (1 - wy) * (1 - wx)
        + gather(y0, x0 + 1) * (1 - wy) * wx
        + gather(y0 + 1, x0) * wy * (1 - wx)
        + gather(y0 + 1, x0 + 1) * wy * wx
    )
    out = val.reshape(n, size, size)
    out *= rng.uniform(0.7, 1.0, (n, 1, 1)).astype(np.float32)
    out += rng.normal(0.0, 0.06, out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0)


def _make_glyph_dataset(
    glyphs_src: list[list[str]], n: int, seed: int, split: int
) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.Generator(np.random.Philox(key=[seed, split]))
    glyphs = _glyph_canvases(glyphs_src)
    labels = rng.integers(0, 10, n, dtype=np.int64)
    images = _render(glyphs, labels, rng)
    return (images * 255).astype(np.uint8)[..., None], labels.astype(np.int32)


def synthetic_mnist(n: int, seed: int = 0, split: int = 0):
    """(images uint8 [n,28,28,1], labels int32 [n]) — procedural digits."""
    return _make_glyph_dataset(_DIGIT_GLYPHS, n, seed, split)


def synthetic_fashion_mnist(n: int, seed: int = 0, split: int = 1):
    return _make_glyph_dataset(_FASHION_GLYPHS, n, seed, split + 100)


def synthetic_cifar10(n: int, seed: int = 0, split: int = 0):
    """(images uint8 [n,32,32,3], labels int32 [n]).

    Class signal = class-specific oriented sinusoid gratings + a class hue,
    randomized in phase/contrast, plus broadband noise. A small conv net
    separates these easily; a linear probe does not (phases are random), so
    it exercises real representation learning.
    """
    size = 32
    rng = np.random.Generator(np.random.Philox(key=[seed, 1000 + split]))
    labels = rng.integers(0, 10, n, dtype=np.int64)
    yy, xx = np.meshgrid(
        np.linspace(0, 2 * np.pi, size, dtype=np.float32),
        np.linspace(0, 2 * np.pi, size, dtype=np.float32),
        indexing="ij",
    )
    # class k -> frequency (1 + k//2), orientation (k * 36°)
    ks = labels.astype(np.float32)
    freq = (1.0 + ks // 2)[:, None, None]
    theta = (ks * (np.pi / 5.0))[:, None, None]
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1)).astype(np.float32)
    proj = np.cos(theta) * yy[None] + np.sin(theta) * xx[None]
    grating = np.sin(freq * proj + phase)
    contrast = rng.uniform(0.4, 1.0, (n, 1, 1)).astype(np.float32)
    lum = 0.5 + 0.35 * contrast * grating
    hue = (ks[:, None, None] / 10.0 + rng.uniform(-0.03, 0.03, (n, 1, 1))) % 1.0
    # cheap HSV->RGB with s=0.6, v=lum
    h6 = (hue * 6.0) % 6.0
    c = 0.6 * lum
    x_ = c * (1 - np.abs(h6 % 2 - 1))
    m = lum - c
    zeros = np.zeros_like(c)
    sector = h6.astype(np.int32) % 6
    rgb_by_sector = np.stack(
        [
            np.stack([c, x_, zeros], -1),
            np.stack([x_, c, zeros], -1),
            np.stack([zeros, c, x_], -1),
            np.stack([zeros, x_, c], -1),
            np.stack([x_, zeros, c], -1),
            np.stack([c, zeros, x_], -1),
        ]
    )  # (6, n, H, W, 3)
    img = np.take_along_axis(
        rgb_by_sector, sector[None, ..., None].repeat(3, -1), axis=0
    )[0] + m[..., None]
    img += rng.normal(0, 0.05, img.shape).astype(np.float32)
    img = np.clip(img, 0, 1)
    return (img * 255).astype(np.uint8), labels.astype(np.int32)
