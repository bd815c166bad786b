"""Whole-scene tiled inference (counterpart of ``ever_tpu/magic/tiled.py``).

Every sliding-window tile of the scene is predicted in batches of
``tile_batch``; the predictions are pasted into an f32 canvas on the device
together with an overlap count, and the canvas is normalised once at the
end.  The tail batch is filled with repeats of the last box at weight 0, so
``predict_fn`` always sees the same batch shape and the pad tiles change
nothing.  With ``tta='d4'`` each tile batch of B becomes its 8·B dihedral
variants, predicted in one call and averaged back before pasting.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.magic._transform_impl import d4_tta
from ever_tpu_torch.magic.sliding_window import sliding_window

__all__ = ['tiled_inference']


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
        mesh, axis: tiles split over several cards: the parallel slice,
            which raises ``NotImplementedError``.
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
    if mesh is not None:
        raise NotImplementedError('multi-device tiled inference (mesh) is the '
                                  'parallel slice (ROADMAP.md A.9)')
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
    n_batches = math.ceil(n_tiles / tile_batch)
    pad = n_batches * tile_batch - n_tiles
    ys += [ys[-1]] * pad
    xs += [xs[-1]] * pad

    acc = torch.zeros((h, w, num_classes), dtype=torch.float32, device=image.device)
    cnt = torch.zeros((h, w, 1), dtype=torch.float32, device=image.device)
    with torch.no_grad():
        for start in range(0, n_batches * tile_batch, tile_batch):
            idx = range(start, start + tile_batch)
            tiles = torch.stack([image[ys[i]:ys[i] + k, xs[i]:xs[i] + k]
                                 for i in idx])
            preds = (d4_tta(predict, tiles) if tta else predict(tiles)).float()
            for j, i in enumerate(idx):
                if i >= n_tiles:          # pad tile: weight 0
                    continue
                acc[ys[i]:ys[i] + k, xs[i]:xs[i] + k] += preds[j]
                cnt[ys[i]:ys[i] + k, xs[i]:xs[i] + k] += 1.0
    out = acc / cnt.clamp_min(1.0)
    return out[:h0, :w0] if (h, w) != (h0, w0) else out
