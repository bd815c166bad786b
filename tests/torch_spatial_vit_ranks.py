"""The rank side of ``tests/test_torch_spatial_vit.py``: each worker runs in
a gloo rank on the CPU, reads the inputs the test saved
(``vit-inputs.pt``), trains on a ``('data',)`` mesh of every rank and saves
what the rank computed (``vit-rank{r}.pt``).  No JAX here: the ranks start
without it."""

import contextlib
import copy

import torch

from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel import spatial
from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state
from torch_spatial_ranks import _save, _start, float32_parts_in_float64, seeded_init

# a 2-block trunk at vit_small's width (6 heads of 64), registered in both
# packages' VIT_SPECS by the test and here
VIT_2BLOCK = ('vit_2block', (2, 384, 6, 4.0, 'mlp'))
LR = 0.01
DROP_PATH_RATE = 0.3


def register_vit_2block() -> None:
    tvit.VIT_SPECS[VIT_2BLOCK[0]] = VIT_2BLOCK[1]


def sgd():
    """SGD + momentum 0.9 at a constant LR (no schedule)."""
    return tbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})[0].build(LR)


def dinoseg(inp: dict, **backbone) -> torch.nn.Module:
    """The test's DinoSeg with its weights, the backbone config updated."""
    cfg = copy.deepcopy(inp['cfg'])
    cfg['backbone'].update(backbone)
    model = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    model.load_state_dict(inp['state_dict'])
    return model


def one_step(model, batch, mesh=None) -> dict:
    """One SGD step of ``model`` over the strips of ``mesh``'s ``'data'``
    axis, or unsharded without a mesh: its metrics, step count, state and
    what the step sent."""
    tx = sgd()
    step = (build_train_step(model, tx) if mesh is None else
            spatial.build_spatial_train_step(model, tx, mesh=mesh, device='cpu'))
    state, metrics = step(create_train_state(model, tx), batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()}, step=state.step,
                state={k: v.clone() for k, v in model.state_dict().items()},
                stats=dict(getattr(step, 'stats', {})))


@contextlib.contextmanager
def recorded_drop_masks(masks: list):
    """While entered, every drop-path keep mask the ViT draws is appended
    to ``masks``."""
    draw = tvit.drop_path_mask

    def recording(*args, **kwargs):
        keep = draw(*args, **kwargs)
        masks.append(keep.clone())
        return keep

    tvit.drop_path_mask = recording
    try:
        yield
    finally:
        tvit.drop_path_mask = draw


def trunk_tokens(model, x) -> tuple:
    """The DinoSeg trunk's normalised cls, storage and patch tokens of an
    eval forward of ``x``."""
    feats = model.vit(x)
    return feats['x_norm_clstoken'], feats['x_storage_tokens'], feats['x_norm_patchtokens']


def vit_worker(rank, world, init, out):
    """The narrow DinoSeg over ``world`` strips, one step each with
    ``remat`` None and ``'full'``, and with stochastic depth (its keep
    masks recorded); FarSeg-R18 (float64, its float32 parts in float64)
    with every stage checkpointed (``with_cp``); the trunk's eval forward
    on the strip (its cls, storage and patch tokens).  The unsharded steps
    and forward on the whole tile run on the ranks in turn: DinoSeg's, its
    drop-path step and the trunk's forward on rank 0, FarSeg's on the
    last."""
    inp = _start(rank, world, init, out, 'vit')
    register_vit_2block()
    mesh = tmesh.make_mesh(('data',))
    batch, whole = (inp['x'], inp['y']), (torch.from_numpy(inp['x']), torch.from_numpy(inp['y']))
    res = {}
    for remat in (None, 'full'):
        res[f'strips/{remat}'] = one_step(dinoseg(inp, remat=remat), batch, mesh)
    masks = []
    with recorded_drop_masks(masks):
        res['drop/strips'] = one_step(dinoseg(inp, drop_path_rate=DROP_PATH_RATE), batch, mesh)
    res['drop/masks'] = masks

    def farseg():
        model = tbuilder.make_model({'type': 'FarSeg', 'params': inp['farseg_cfg']},
                                    device='cpu').double()
        return seeded_init(model, 9)

    tile = (inp['farseg_x'], inp['farseg_y'])
    with float32_parts_in_float64():
        res['with_cp/strips'] = one_step(farseg(), tile, mesh)
    model, h = dinoseg(inp), inp['x'].shape[1] // world
    with torch.no_grad(), mesh.with_batch_axes(('data',)), spatial.Strips(mesh, 'data'):
        res['trunk'] = trunk_tokens(model, whole[0][:, rank * h:(rank + 1) * h])
    if rank == 0:
        with torch.no_grad():
            res['trunk/unsharded'] = trunk_tokens(model, whole[0])
        res['unsharded'] = one_step(dinoseg(inp), whole)
        res['drop/unsharded'] = one_step(dinoseg(inp, drop_path_rate=DROP_PATH_RATE), whole)
    if rank == world - 1:
        with float32_parts_in_float64():
            res['with_cp/unsharded'] = one_step(farseg(), tuple(map(torch.from_numpy, tile)))
    _save(out, 'vit', rank, res)
