"""The rank side of ``tests/test_torch_spatial_encoders.py``: each worker
runs in a gloo rank on the CPU, reads the inputs the test saved
(``enc-inputs.pt``), trains each model one step over the strips of a
``('data',)`` mesh of every rank, runs the causal attention on its strip of
tokens, and saves what the rank computed (``enc-rank{r}.pt``).  No JAX
here: the ranks start without it."""

import torch
import torch.nn as nn

from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import fpn as tfpn
from ever_tpu_torch.module import loss as L
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel import spatial
from torch_spatial_ranks import _save, _start
from torch_spatial_vit_ranks import one_step, recorded_drop_masks

# vit_small cut to 4 blocks (4 taps need 4 distinct blocks), registered in
# both packages' VIT_SPECS by the test and here
VIT_D4 = ('vit_small_d4', (4, 384, 6, 4.0, 'mlp'))
CLASSES, FPN_WIDTH, DECODER_WIDTH = 5, 32, 16
DROP_PATH_RATE = 0.3
CAUSAL = dict(dim=32, num_heads=4)


def register_vit_d4() -> None:
    tvit.VIT_SPECS[VIT_D4[0]] = VIT_D4[1]


class ViTFPN(nn.Module):
    """A user's model: ``ViTEncoder`` (``vit_small_d4``, four taps resized
    to os4–os32) → ``FPN`` → ``AssymetricDecoder`` (its classifier and ×4
    bilinear) → float32 logits → the cross-entropy (255 ignored)."""

    def __init__(self, remat=None, drop_path_rate: float = 0.0):
        super().__init__()
        self.encoder = tvit.ViTEncoder(dict(vit_type=VIT_D4[0], remat=remat,
                                            drop_path_rate=drop_path_rate))
        self.fpn = tfpn.FPN((VIT_D4[1][1],) * 4, FPN_WIDTH)
        self.decoder = tfpn.AssymetricDecoder(FPN_WIDTH, DECODER_WIDTH, classifier_config=dict(
            num_classes=CLASSES, scale_factor=4))

    def forward(self, x, y=None, train: bool = False, generator=None):
        feats = self.encoder(x, train, generator)
        logits = self.decoder(self.fpn(feats, train), train).permute(0, 2, 3, 1).float()
        if train and y is not None:
            return dict(cls_loss=L.softmax_ce_loss_with_logits(logits, y, ignore_index=255))
        return torch.softmax(logits, dim=-1)


def vit_fpn(inp: dict, **settings) -> nn.Module:
    model = ViTFPN(**settings)
    model.load_state_dict(inp['vit_state_dict'])
    return model


def farseg(inp: dict, stem: str) -> nn.Module:
    """The narrow FarSeg-R18, float64, with ``stem``."""
    cfg = dict(inp['farseg_cfg'], encoder=dict(inp['farseg_cfg']['encoder'], stem=stem))
    model = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu').double()
    model.load_state_dict(inp['farseg_state_dict'])
    return model


def freenet(inp: dict) -> nn.Module:
    model = tbuilder.make_model({'type': 'FreeNet', 'params': inp['freenet_cfg']},
                                device='cpu').double()
    model.load_state_dict(inp['freenet_state_dict'])
    return model


def causal_attention(inp: dict, rank: int, world: int, strips) -> dict:
    """{is_causal: (output, the input's gradient, the parameters'
    gradients)} of ``CausalSelfAttention`` on this rank's strip of tokens
    under ``strips``, for ``Σ output·probe`` (the probe's rows of the
    strip): each parameter's gradient is this rank's share."""
    x, probe = torch.from_numpy(inp['causal_x']), torch.from_numpy(inp['causal_probe'])
    n = x.shape[1] // world
    rows = slice(rank * n, (rank + 1) * n)
    res = {}
    for is_causal in (True, False):
        attn = tvit.CausalSelfAttention(**CAUSAL)
        attn.load_state_dict(inp['causal_state_dict'])
        xs = x[:, rows].clone().requires_grad_()
        with strips:
            y = attn(xs, is_causal)
        (y * probe[:, rows]).sum().backward()
        res[is_causal] = (y.detach(), xs.grad,
                          {k: p.grad for k, p in attn.named_parameters()})
    return res


def encoders_worker(rank, world, init, out):
    """ViTEncoder + FPN + AssymetricDecoder with ``remat`` None and
    ``'full'`` and with stochastic depth (its keep masks recorded), the
    FarSeg-R18 with ``stem='s2d_input'`` on the folded tile and with
    ``stem='conv'`` on the unfolded one, FreeNet, one step each over the
    strips; the causal attention; and the drop-path step unsharded on rank
    0."""
    inp = _start(rank, world, init, out, 'enc')
    register_vit_d4()
    mesh = tmesh.make_mesh(('data',))
    vit_batch = (inp['vit_x'], inp['vit_y'])
    res = {}
    for remat in (None, 'full'):
        res[f'vit/{remat}'] = one_step(vit_fpn(inp, remat=remat), vit_batch, mesh)
    masks = []
    with recorded_drop_masks(masks):
        res['vit/drop'] = one_step(vit_fpn(inp, drop_path_rate=DROP_PATH_RATE), vit_batch, mesh)
    res['vit/drop_masks'] = masks
    res['s2d'] = one_step(farseg(inp, 's2d_input'), (inp['s2d_x'], inp['farseg_y']), mesh)
    res['conv'] = one_step(farseg(inp, 'conv'), (inp['farseg_x'], inp['farseg_y']), mesh)
    res['freenet'] = one_step(freenet(inp), (inp['freenet_x'], inp['freenet_y']), mesh)
    res['causal'] = causal_attention(inp, rank, world, spatial.Strips(mesh, 'data'))
    if rank == 0:
        res['vit/drop_unsharded'] = one_step(vit_fpn(inp, drop_path_rate=DROP_PATH_RATE),
                                             tuple(map(torch.from_numpy, vit_batch)))
    _save(out, 'enc', rank, res)
