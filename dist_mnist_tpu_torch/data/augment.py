"""Data augmentation on the device (port of the reference
`data/augment.py`): pad-reflect, random crop, random horizontal flip.

`random_crop_flip` draws each example's crop origin and flip from an
explicit `torch.Generator` on the images' device; `crop_flip` is the
deterministic core, which takes them (a test feeds it the reference's
draws). The crop and the flip are one gather through index arithmetic:
no padded copy is made, a padded row or column maps straight to the
source pixel it reflects.
"""

from __future__ import annotations

import torch


def _reflect(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Source index of padded position ``idx - pad`` under reflect
    padding (the edge pixel is not repeated, as `jnp.pad(mode="reflect")`
    and `F.pad(mode="reflect")`)."""
    idx = idx.abs()
    return torch.where(idx >= size, 2 * (size - 1) - idx, idx)


def crop_flip(images: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
              flips: torch.Tensor | None, *, pad: int = 4) -> torch.Tensor:
    """``[B, H, W, C]`` images reflect-padded by `pad`, cropped back to
    H x W at per-example origins `oy`, `ox` (ints in ``[0, 2 * pad]``),
    then flipped left-right where `flips` ([B] bool) is true. Any dtype;
    the result has the input's shape and dtype."""
    b, h, w, _ = images.shape
    dev = images.device
    rows = _reflect(oy.to(dev)[:, None] + torch.arange(h, device=dev) - pad,
                    h)
    cols = torch.arange(w, device=dev)
    if flips is not None:
        cols = torch.where(flips.to(dev)[:, None], (w - 1) - cols, cols)
    else:
        cols = cols.expand(b, w)
    cols = _reflect(ox.to(dev)[:, None] + cols - pad, w)
    batch = torch.arange(b, device=dev)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def random_crop_flip(gen: torch.Generator, images: torch.Tensor, *,
                     pad: int = 4, flip: bool = True,
                     global_batch: int | None = None,
                     offset: int = 0) -> torch.Tensor:
    """`crop_flip` at origins drawn uniformly from ``[0, 2 * pad]`` and,
    with `flip`, fair coin flips, all from `gen` (a generator on the
    images' device): the origins first, then the flips. The draws are
    for `global_batch` examples (default the batch's), and the B images
    take draws ``offset : offset + B``: a rank's slice of the global
    batch gets the crops one rank holding the whole batch would draw."""
    b = images.shape[0]
    n = b if global_batch is None else global_batch
    rows = slice(offset, offset + b)
    oy, ox = torch.randint(0, 2 * pad + 1, (2, n), generator=gen,
                           device=images.device)[:, rows]
    flips = (torch.rand((n,), generator=gen, device=images.device)[rows]
             < 0.5 if flip else None)
    return crop_flip(images, oy, ox, flips, pad=pad)
