"""The rank side of ``tests/test_torch_spatial_resize.py``: each worker runs
in a gloo rank on the CPU, reads the inputs the test saved
(``resize-inputs.pt``), resizes its strip of each tile under the strip
context of a ``('data',)`` mesh of every rank and saves the outputs, the
input gradients and the halo bytes it sent (``resize-rank{r}.pt``).  No JAX
here: the ranks start without it."""

import torch

from ever_tpu_torch.module import ops
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel import spatial
from torch_spatial_ranks import _save, _start

# (name, method, scale, align_corners): each a resize of the tile's strip
# by ops.resize (downsample_bilinear: ops.downsample_bilinear to the
# halved shape)
STRIP_CASES = tuple((f'{method} x{scale:g}', method, scale, False)
                    for method in ('nearest', 'bilinear')
                    for scale in (2.0, 4.0, 1.5, 0.5, 0.25)) + (
    ('corners x2', 'bilinear', 2.0, True), ('corners x0.5', 'bilinear', 0.5, True),
    ('downsample_bilinear', 'bilinear', 0.5, False))
# (name, rows of the whole map): a map whole on every rank resized to the
# tile's rows by ops.bilinear_nchw(..., whole=True), growing and shrinking
WHOLE_CASES = (('whole up', 5), ('whole down', 24))


def resize_strip(name: str, x: torch.Tensor) -> torch.Tensor:
    """The strip form of ``STRIP_CASES``'s ``name`` on NHWC ``x``."""
    _, method, scale, corners = next(c for c in STRIP_CASES if c[0] == name)
    if name == 'downsample_bilinear':
        return ops.downsample_bilinear(x, (int(x.shape[1] * scale), int(x.shape[2] * scale)))
    return ops.resize(x, scale=scale, method=method, align_corners=corners)


def resize_worker(rank, world, init, out):
    """Every case of ``STRIP_CASES`` on this rank's strip and of
    ``WHOLE_CASES`` on the whole map: the output, the input's gradient of
    ``Σ output·probe`` (the probe's rows of the strip) and the bytes this
    rank sent."""
    inp = _start(rank, world, init, out, 'resize')
    mesh = tmesh.make_mesh(('data',))
    strips = spatial.Strips(mesh, 'data')
    res = {}
    for name, rows in [(c[0], None) for c in STRIP_CASES] + list(WHOLE_CASES):
        x, probe = (torch.from_numpy(t) for t in inp[name])
        if rows is None:
            h = x.shape[1] // world
            x = x[:, rank * h:(rank + 1) * h]
        xs = x.clone().requires_grad_()
        sent = strips.stats['bytes']
        with strips:
            if rows is None:
                y = resize_strip(name, xs)
            else:
                m = probe.shape[1] // world
                y = ops.bilinear_nchw(xs.permute(0, 3, 1, 2), (m, probe.shape[2]),
                                      whole=True).permute(0, 2, 3, 1)
        m = y.shape[1]
        (y * probe[:, rank * m:(rank + 1) * m]).sum().backward()
        res[name] = (y.detach(), xs.grad, strips.stats['bytes'] - sent)
    _save(out, 'resize', rank, res)
