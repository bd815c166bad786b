"""Whole-scene tiled inference (counterpart of ``ever_tpu/magic/tiled.py``),
and ``pad_crop_apply``.

Every sliding-window tile of the scene is predicted in batches of
``tile_batch``; the predictions are pasted into an f32 canvas on the device
together with an overlap count, and the canvas is normalised once at the
end.  The tail batch is filled with repeats of the last box at weight 0, so
``predict_fn`` always sees the same batch shape and the pad tiles change
nothing.  With ``tta='d4'`` each tile batch of B becomes its 8·B dihedral
variants, predicted in one call and averaged back before pasting.

With ``mesh`` (``parallel/mesh.py``) the tile list is split over the
mesh's processes, one card each, as ``_tiled_inference_sharded`` splits it
over devices in the JAX package: the list is padded with weight-0 repeats
of the last box to a whole number of batches on every rank, each rank
predicts its contiguous share into its own canvas, and one ``all_reduce``
of canvas and counts gives every rank the whole scene.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.magic._transform_impl import d4_tta
from ever_tpu_torch.magic.sliding_window import sliding_window

__all__ = ['tiled_inference', 'pad_crop_apply']


def pad_crop_apply(fn: Callable, x: torch.Tensor, size_divisor: int):
    """Pad NHWC ``x`` with zeros at the bottom and right to a multiple of
    ``size_divisor``, run ``fn`` on it and crop every ``[N, H', W', ...]``
    output back to ``[:, :H, :W]`` (a class-index map ``[N, H, W]``
    included), as ``ever_tpu/magic/tiled.py``'s ``pad_crop_apply`` does."""
    n, h, w, c = x.shape
    nh = math.ceil(h / size_divisor) * size_divisor
    nw = math.ceil(w / size_divisor) * size_divisor
    out = fn(F.pad(x, (0, 0, 0, nw - w, 0, nh - h)))
    return tree_map(lambda t: t[:, :h, :w], out)


def tiled_inference(predict_fn: Callable,
                    image: Union[np.ndarray, torch.Tensor],
                    kernel_size: int, stride: int, num_classes: int,
                    tile_batch: int = 8, mesh=None, axis: str = 'data',
                    tta: Optional[str] = None, variables=None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> torch.Tensor:
    """Run ``predict_fn`` over every sliding-window tile and average overlaps.

    Args:
        predict_fn: ``[B, k, k, C] -> [B, k, k, num_classes]`` (probabilities
            or logits; whatever it returns is averaged), or
            ``(variables, tiles) -> ...`` when ``variables`` is given (e.g. a
            ``state_dict`` for ``torch.func.functional_call``).
        image: ``[H, W, C]`` scene (numpy array or tensor).
        kernel_size/stride: tiling geometry; ``stride > kernel_size`` would
            leave uncovered pixels and raises.
        num_classes: output channels.
        tile_batch: tiles per ``predict_fn`` call.
        mesh, axis: split the tiles over the processes of the mesh's
            ``axis`` (module docstring); every rank calls with the same scene
            and gets the whole of it.
        tta: None or ``'d4'`` (square tiles).
        variables: passed to ``predict_fn`` first, as in the JAX package.
        device: where the scene and the canvas live (the GPU unless
            ``device='cpu'``).

    Returns ``[H, W, num_classes]`` f32 on ``device``.
    """
    if stride > kernel_size:
        raise ValueError(f'stride ({stride}) must be <= kernel_size '
                         f'({kernel_size}) or the tiling leaves uncovered '
                         f'pixels')
    if tta not in (None, 'd4'):
        raise ValueError(f"tta must be None or 'd4', got {tta!r}")
    predict = predict_fn if variables is None else (lambda t: predict_fn(variables, t))
    image = torch.as_tensor(image, device=get_device(device))
    h0, w0, _ = image.shape
    k = kernel_size
    # scenes smaller than one tile: pad up to the tile, crop at the end
    if h0 < k or w0 < k:
        image = F.pad(image, (0, 0, 0, max(0, k - w0), 0, max(0, k - h0)))
    h, w, _ = image.shape
    boxes = sliding_window((h, w), k, stride)
    ys, xs = boxes[:, 1].tolist(), boxes[:, 0].tolist()
    n_tiles = len(ys)
    group = None if mesh is None else mesh.axis_group(axis)
    ranks = 1 if group is None else tdist.get_world_size(group)
    rank = 0 if group is None else tdist.get_rank(group)
    per_rank = math.ceil(n_tiles / (ranks * tile_batch)) * tile_batch
    pad = per_rank * ranks - n_tiles
    ys += [ys[-1]] * pad
    xs += [xs[-1]] * pad

    # the class sums and, in the last channel, the overlap count
    acc = torch.zeros((h, w, num_classes + 1), dtype=torch.float32, device=image.device)
    with torch.no_grad():
        for start in range(rank * per_rank, (rank + 1) * per_rank, tile_batch):
            idx = range(start, start + tile_batch)
            tiles = torch.stack([image[ys[i]:ys[i] + k, xs[i]:xs[i] + k]
                                 for i in idx])
            preds = (d4_tta(predict, tiles) if tta else predict(tiles)).float()
            for j, i in enumerate(idx):
                if i >= n_tiles:          # pad tile: weight 0
                    continue
                acc[ys[i]:ys[i] + k, xs[i]:xs[i] + k, :num_classes] += preds[j]
                acc[ys[i]:ys[i] + k, xs[i]:xs[i] + k, num_classes] += 1.0
    if ranks > 1:
        tdist.all_reduce(acc, group=group)
    out = acc[..., :num_classes] / acc[..., num_classes:].clamp_min(1.0)
    return out[:h0, :w0] if (h, w) != (h0, w0) else out
