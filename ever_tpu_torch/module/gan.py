"""DCGAN generator and discriminator under the GAN training contract
(counterpart of ``ever_tpu/module/gan.py``).

A :class:`DCGAN` holds the two roles as its ``G`` and ``D`` children and
defines ``d_loss(batch, train, generator)`` and ``g_loss(batch, train,
generator)``, each taking the batch whole and returning a loss dict (keys
ending in ``loss`` are summed): what ``trainer/gan.py``'s two-optimizer
step drives.  ``batch`` is real images in [-1, 1], NHWC, as in the JAX
package; the layers compute NCHW inside.

Flax's layers in PyTorch terms: ``ConvTranspose(k=4, stride 2,
'SAME')`` is ``conv_transpose2d(stride=2, padding=1)`` with the kernel
flipped in both spatial axes (``util.weight_io.convert_flax_dcgan`` flips
it); ``Conv(k=4, stride 2, 'SAME')`` on an even size pads 1 on each side;
``BatchNorm``'s momentum 0.99 moves the running statistics by 1 % of the
batch's biased variance (:class:`~ever_tpu_torch.module.ops.BatchNorm2d`,
global under the data mesh).  The dense layer after the latent keeps
flax's ``(h, w, c)`` order of its outputs, and the discriminator flattens
``(h, w, c)`` before its logit, so the weights carry over unpermuted.

Every call of G or D in train mode moves its running statistics: ``d_loss``
moves G's once and D's twice (real, then fake), ``g_loss`` G's and D's
once each, in the JAX package's order.

The latent: the JAX model draws it from its ``'dropout'`` stream; here it is
``torch.randn`` from the step's generator (``ROADMAP.md`` §C).  Inside a
data-parallel step each rank draws the latent of the whole global batch
from the same generator and keeps its own rows, so two ranks see the
latents one process would.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.ops import BatchNorm2d
from ever_tpu_torch.parallel.mesh import data_shard

__all__ = ['DCGAN', 'DCGANGenerator', 'DCGANDiscriminator']

# flax BatchNorm's defaults
_BN_MOMENTUM, _BN_EPS = 0.99, 1e-5


def _dtype(name) -> torch.dtype:
    return getattr(torch, str(name)) if not isinstance(name, torch.dtype) else name


class DCGANGenerator(nn.Module):
    """Latent ``[N, latent_dim]`` → image ``[N, image_size, image_size,
    channels]`` in (-1, 1): a dense layer to 4×4×width, BatchNorm, ReLU,
    then stride-2 transposed convolutions halving the width (to no less
    than ``base_width``) up to the image size, the last to ``channels``
    and tanh."""

    def __init__(self, image_size: int = 64, channels: int = 3, latent_dim: int = 128,
                 base_width: int = 64, dtype=torch.float32):
        super().__init__()
        self.dtype = _dtype(dtype)
        size, n_up = 4, 0
        while size < image_size:
            size *= 2
            n_up += 1
        width = base_width * 2 ** min(n_up - 1, 3)
        self.width = width
        self.fc = nn.Linear(latent_dim, 16 * width)
        self.bn_fc = BatchNorm2d(width, _BN_EPS, _BN_MOMENTUM)
        ups, bns = [], []
        for i in range(n_up):
            out = channels if i == n_up - 1 else max(base_width, width // 2)
            ups.append(nn.ConvTranspose2d(width, out, 4, stride=2, padding=1))
            if i < n_up - 1:
                bns.append(BatchNorm2d(out, _BN_EPS, _BN_MOMENTUM))
            width = out
        self.ups = nn.ModuleList(ups)
        self.bns = nn.ModuleList(bns)

    def forward_nchw(self, z, train: bool = False):
        w = self.fc.weight.to(self.dtype)
        x = F.linear(z.to(self.dtype), w, self.fc.bias.to(self.dtype))
        x = x.reshape(z.shape[0], 4, 4, self.width).permute(0, 3, 1, 2)
        x = F.relu(self.bn_fc(x, train))
        for i, up in enumerate(self.ups):
            x = F.conv_transpose2d(x, up.weight.to(self.dtype), up.bias.to(self.dtype),
                                   stride=2, padding=1)
            if i < len(self.bns):
                x = F.relu(self.bns[i](x, train))
        return torch.tanh(x)

    def forward(self, z, train: bool = False):
        return self.forward_nchw(z, train).permute(0, 2, 3, 1)


class DCGANDiscriminator(nn.Module):
    """Image ``[N, H, W, C]`` → one logit a sample: stride-2 4×4
    convolutions doubling the width (to at most 8 × ``base_width``) until
    the map is 4×4, BatchNorm after all but the first, leaky ReLU 0.2, and a
    dense logit over the flattened map.  ``in_channels`` and
    ``image_size`` fix the layers' shapes, which flax infers."""

    def __init__(self, base_width: int = 64, dtype=torch.float32, in_channels: int = 3,
                 image_size: int = 64):
        super().__init__()
        self.dtype = _dtype(dtype)
        downs, bns = [], []
        width, size, c = base_width, image_size, in_channels
        while size > 4:
            downs.append(nn.Conv2d(c, width, 4, stride=2, padding=1))
            if downs[1:]:
                bns.append(BatchNorm2d(width, _BN_EPS, _BN_MOMENTUM))
            c, size = width, (size + 1) // 2
            width = min(width * 2, base_width * 8)
        self.downs = nn.ModuleList(downs)
        self.bns = nn.ModuleList(bns)
        self.logit = nn.Linear(size * size * c, 1)

    def forward_nchw(self, x, train: bool = False):
        x = x.to(self.dtype)
        for i, down in enumerate(self.downs):
            x = F.conv2d(x, down.weight.to(self.dtype), down.bias.to(self.dtype),
                         stride=2, padding=1)
            if i > 0:       # DCGAN: no norm on the first conv
                x = self.bns[i - 1](x, train)
            x = F.leaky_relu(x, 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.linear(x, self.logit.weight.to(self.dtype),
                        self.logit.bias.to(self.dtype))[:, 0]

    def forward(self, x, train: bool = False):
        return self.forward_nchw(x.permute(0, 3, 1, 2), train)


@registry.MODEL.register()
class DCGAN(ERModule):
    """Unconditional DCGAN under the GAN contract (module docstring); its
    default call is ``d_loss``, as the JAX model's."""

    def set_default_config(self):
        self.config.update(dict(
            image_size=64,
            channels=3,
            latent_dim=128,
            base_width=64,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        c = self.config
        dtype = _dtype(c.dtype)
        self.G = DCGANGenerator(int(c.image_size), int(c.channels), int(c.latent_dim),
                                int(c.base_width), dtype)
        self.D = DCGANDiscriminator(int(c.base_width), dtype, int(c.channels),
                                    int(c.image_size))

    def _latent(self, n: int, generator: Optional[torch.Generator] = None):
        """``n`` latents of this rank: its rows of the global batch's draw
        (the whole draw outside a data-parallel step)."""
        rank, size = data_shard()
        dev = self.G.fc.weight.device
        z = torch.randn((n * size, int(self.config.latent_dim)), generator=generator,
                        device=dev, dtype=_dtype(self.config.dtype))
        return z[rank * n:(rank + 1) * n]

    def _images(self, batch):
        return torch.as_tensor(batch, device=self.G.fc.weight.device).permute(0, 3, 1, 2)

    def d_loss(self, batch, train: bool = False, generator: Optional[torch.Generator] = None):
        """The discriminator's non-saturating BCE (real → 1, fake → 0) in
        float32 and its accuracy on the real images.  G runs without a
        graph: this loss trains D only."""
        real = self._images(batch)
        with torch.no_grad():
            fake = self.G.forward_nchw(self._latent(real.shape[0], generator), train)
        logit_real = self.D.forward_nchw(real, train).float()
        logit_fake = self.D.forward_nchw(fake, train).float()
        loss = F.softplus(-logit_real).mean() + F.softplus(logit_fake).mean()
        return dict(d_loss=loss, d_real_acc=(logit_real > 0).float().mean())

    def g_loss(self, batch, train: bool = False, generator: Optional[torch.Generator] = None):
        """The generator's non-saturating loss, softplus(−D(G(z))), in
        float32; its gradient reaches D's parameters too, which only D's
        optimizer steps."""
        fake = self.G.forward_nchw(self._latent(len(batch), generator), train)
        logit_fake = self.D.forward_nchw(fake, train).float()
        return dict(g_loss=F.softplus(-logit_fake).mean())

    def generate(self, z, train: bool = False):
        return self.G(torch.as_tensor(z, device=self.G.fc.weight.device), train)

    def forward(self, batch, train: bool = False, generator: Optional[torch.Generator] = None):
        return self.d_loss(batch, train, generator)
