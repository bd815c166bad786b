"""Batched augmentation on the device (counterpart of
``ever_tpu/preprocess/device.py``): a random crop, a random symmetry of the
square (a rotation by k quarter turns, then a horizontal flip) and the
normalisation, over a whole ``[N, H, W, C]`` batch on the batch's device.

The draws take an explicit ``torch.Generator`` on the batch's device in
place of the JAX key: every sample's crop offset, k and flip are drawn on
the device in one call each, and the crop and the symmetry are one gather
of index arithmetic, so there is no Python loop over samples and the host
never waits for the device.  The symmetry needs square crops (or a square
batch without a crop), as in the JAX package.  These are plain torch
operations: the JAX functions are plain ``jnp`` too.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ever_tpu_torch.preprocess.function import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    channel_constants,
    mean_std_normalize,
)

__all__ = ['dihedral_augment', 'random_crop', 'batch_augment']


def _check_generator(generator: torch.Generator, x: torch.Tensor) -> None:
    if generator.device.type != x.device.type:
        raise ValueError(f'the generator is on {generator.device} and the batch on '
                         f'{x.device}: draw on the batch\'s device')


def _d4_source(t: int, k: torch.Tensor, flip: torch.Tensor, device):
    """Source rows and columns ``[N, t, t]`` of each output pixel of
    ``rot90(·, k)`` (numpy's convention) then a horizontal flip, for ``[N]``
    draws ``k`` and ``flip``."""
    r = torch.arange(t, device=device)[None, :, None]
    c = torch.arange(t, device=device)[None, None, :]
    k, flip = k[:, None, None], flip[:, None, None]
    c = torch.where(flip, t - 1 - c, c)                 # the flip after the rotation
    rows = torch.where(k == 0, r, torch.where(k == 1, c, torch.where(k == 2, t - 1 - r,
                                                                     t - 1 - c)))
    cols = torch.where(k == 0, c, torch.where(k == 1, t - 1 - r, torch.where(k == 2, t - 1 - c,
                                                                              r)))
    return rows, cols


def _crop_d4(x: torch.Tensor, size: Tuple[int, int], y0, x0, k, flip) -> torch.Tensor:
    """``[N, th, tw, ...]`` windows of ``x [N, H, W, ...]`` at offsets
    ``(y0, x0)`` (``[N]``, or None for 0), each turned by ``(k, flip)``
    (``[N]``, or None for the identity), as one gather."""
    n, h, w = x.shape[:3]
    th, tw = size
    if k is None:
        rows = torch.arange(th, device=x.device)[None, :, None]
        cols = torch.arange(tw, device=x.device)[None, None, :]
    else:
        rows, cols = _d4_source(th, k, flip, x.device)
    if y0 is not None:
        rows = rows + y0[:, None, None]
        cols = cols + x0[:, None, None]
    index = (rows * w + cols).expand(n, th, tw).reshape(n, th * tw)
    batch = torch.arange(n, device=x.device)[:, None]
    return x.reshape(n, h * w, *x.shape[3:])[batch, index].reshape(n, th, tw, *x.shape[3:])


def _draw_offsets(generator, n: int, h: int, w: int, size, device):
    """``[N]`` row and column offsets, uniform over the windows of ``size``
    that fit in ``h × w``, from one draw of ``[N, 2]`` uniforms."""
    th, tw = size
    if th > h or tw > w:
        raise ValueError(f'a crop of {th}x{tw} does not fit in {h}x{w}')
    span = channel_constants((h - th + 1, w - tw + 1), device)
    u = torch.rand((n, 2), generator=generator, device=device)
    off = torch.minimum((u * span).long(), span.long() - 1)
    return off[:, 0], off[:, 1]


def _draw_d4(generator, n: int, device):
    k = torch.randint(0, 4, (n,), generator=generator, device=device)
    flip = torch.randint(0, 2, (n,), generator=generator, device=device).bool()
    return k, flip


def _apply_d4(image: torch.Tensor, k, flip) -> torch.Tensor:
    """``rot90(image, k)`` then, with ``flip``, a horizontal flip, of one
    square ``[H, W, C]`` or ``[H, W]`` sample."""
    if image.shape[0] != image.shape[1]:
        raise ValueError(f'the symmetries of the square need H == W, got {tuple(image.shape)}')
    dev = image.device
    k = torch.as_tensor(k, device=dev).reshape(1)
    flip = torch.as_tensor(flip, device=dev).reshape(1).bool()
    return _crop_d4(image[None], image.shape[:2], None, None, k, flip)[0]


def dihedral_augment(generator: torch.Generator, image: torch.Tensor,
                     mask: Optional[torch.Tensor] = None):
    """A random symmetry of the square of one sample (image ``[H, H, C]``,
    mask ``[H, H]``): ``(image, mask)``."""
    _check_generator(generator, image)
    k, flip = _draw_d4(generator, 1, image.device)
    return (_apply_d4(image, k, flip),
            None if mask is None else _apply_d4(mask, k, flip))


def random_crop(generator: torch.Generator, image: torch.Tensor, size: Tuple[int, int],
                mask: Optional[torch.Tensor] = None):
    """A random ``size`` window of one sample (image ``[H, W, C]``, mask
    ``[H, W]``): ``(image, mask)``."""
    _check_generator(generator, image)
    y0, x0 = _draw_offsets(generator, 1, image.shape[0], image.shape[1], size, image.device)
    return (_crop_d4(image[None], size, y0, x0, None, None)[0],
            None if mask is None else _crop_d4(mask[None], size, y0, x0, None, None)[0])


def batch_augment(generator: torch.Generator, images: torch.Tensor,
                  masks: Optional[torch.Tensor] = None,
                  crop_size: Optional[Tuple[int, int]] = None, dihedral: bool = True,
                  normalize: bool = True, mean: Sequence[float] = IMAGENET_MEAN,
                  std: Sequence[float] = IMAGENET_STD, return_draws: bool = False):
    """A random crop (with ``crop_size``), then a random symmetry of the
    square (with ``dihedral``), then ``(x − mean) / std`` in float32 (with
    ``normalize``) of ``images [N, H, W, C]`` (uint8 or float, 0-255) and
    ``masks [N, H, W]`` (their dtype kept), drawn by ``generator`` on the
    batch's device.  Returns ``(images, masks)``, and with ``return_draws``
    a third item: the ``[N]`` draws ``{'y', 'x', 'k', 'flip'}`` that were
    made (the crop's top-left corner, the quarter turns, the flips)."""
    _check_generator(generator, images)
    n, h, w = images.shape[:3]
    dev = images.device
    size = tuple(crop_size) if crop_size is not None else (h, w)
    if dihedral and size[0] != size[1]:
        raise ValueError(f'the symmetries of the square need square crops, got {size}')
    draws = {}
    if crop_size is not None:
        draws['y'], draws['x'] = _draw_offsets(generator, n, h, w, size, dev)
    if dihedral:
        draws['k'], draws['flip'] = _draw_d4(generator, n, dev)
    if draws:
        args = (size, draws.get('y'), draws.get('x'), draws.get('k'), draws.get('flip'))
        images = _crop_d4(images, *args)
        if masks is not None:
            masks = _crop_d4(masks, *args)
    if normalize:
        images = mean_std_normalize(images, mean, std)
    return (images, masks, draws) if return_draws else (images, masks)
