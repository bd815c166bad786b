"""The rank side of ``tests/test_torch_spatial.py`` and
``tests/test_torch_spatial_train.py``: each worker runs in a gloo rank on
the CPU, reads the inputs its test saved (``{job}-inputs.pt``), runs the
port's spatial layouts on a ``('data',)`` mesh of every rank and saves what
the rank computed (``{job}-rank{r}.pt``).  No JAX here: the ranks start
without it."""

import contextlib
import copy
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import dist
from ever_tpu_torch.module import loss as L
from ever_tpu_torch.module import ops
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel import spatial
from ever_tpu_torch.parallel.spmd import create_train_state


def _start(rank, world, init, out, job):
    torch.set_num_threads(1)
    dist.init_dist_env(init, world, rank, backend='gloo')
    return torch.load(os.path.join(out, f'{job}-inputs.pt'), weights_only=False)


def _save(out, job, rank, res):
    torch.save(res, os.path.join(out, f'{job}-rank{rank}.pt'))


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return 'returned'


class ConvStack(nn.Module):
    """``tests/test_spatial.py``'s ``_ConvStack``: three 3×3 convs (width
    ``width``, bias, ReLU after each) and a 1×1 head of 4, NHWC in and out;
    ``load_flax`` takes the flax module's params."""

    def __init__(self, cin: int = 3, width: int = 8, depth: int = 3):
        super().__init__()
        self.convs = nn.ModuleList(ops.Conv2d(cin if i == 0 else width, width, 3, bias=True)
                                   for i in range(depth))
        self.out = ops.Conv2d(width, 4, 1, bias=True)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.out(x).permute(0, 2, 3, 1)

    def load_flax(self, params: dict) -> 'ConvStack':
        with torch.no_grad():
            for i, conv in enumerate(list(self.convs) + [self.out]):
                p = params[f'c{i}' if i < len(self.convs) else 'out']
                conv.weight.copy_(torch.as_tensor(p['kernel']).permute(3, 2, 0, 1))
                conv.bias.copy_(torch.as_tensor(p['bias']))
        return self


def mse(logits, target):
    return ((logits - target[..., None]) ** 2).mean()


class OpsNet(nn.Module):
    """A float64 segmentation net through strip forms none of which
    computes in float32: a 3×3 conv (symmetric padding) with BatchNorm, a
    3×3/2 conv with lax's ``'SAME'`` (0 rows above, 1 below), a ``'SAME'``
    3×3/2 max pool off K8's route, a dilated 3×3 conv, a 3×3/1 average
    pool, element dropout, nearest ×2 by ``resize`` and by
    ``upsample_nearest_int``, a 1×1 classifier and the cross-entropy.
    ``forward(x, y, train, generator)`` as the models'.  (The global and
    adaptive pools accumulate in float32: :func:`pools`.)"""

    def __init__(self, classes: int = 3, width: int = 8):
        super().__init__()
        self.c1 = ops.Conv2d(3, width, 3)
        self.bn1 = ops.BatchNorm2d(width)
        self.c2 = ops.Conv2d(width, width, 3, stride=2)
        self.bn2 = ops.BatchNorm2d(width)
        self.c3 = ops.Conv2d(width, width, 3, dilation=2, bias=True)
        self.cls = ops.Conv2d(width, classes, 1, bias=True)

    def forward(self, x, y=None, train=False, generator=None):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.c1(x), train))
        x = F.relu(self.bn2(self.c2(x), train))
        x = ops.max_pool(x.permute(0, 2, 3, 1), 3, 2, 'SAME').permute(0, 3, 1, 2)
        x = self.c3(x)
        x = ops.avg_pool(x.permute(0, 2, 3, 1), 3, 1, 'SAME').permute(0, 3, 1, 2)
        x = ops.dropout(x, 0.25, train, generator)
        x = ops.resize(x.permute(0, 2, 3, 1), scale=2, method='nearest').permute(0, 3, 1, 2)
        logits = ops.upsample_nearest_int(self.cls(x), 2).permute(0, 2, 3, 1)
        return dict(cls_loss=L.softmax_ce_loss_with_logits(logits, y))


def _sgd(lr=0.05):
    sched = tbuilder.make_learningrate({'type': 'poly', 'params': dict(
        base_lr=lr, power=0.9, max_iters=20)})
    factory, _ = tbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    return sched, factory.build(sched)


POOLS = (('global', None), ('unit_bins', (1, 1)))


def pools(x: torch.Tensor, probes: dict, strips=None) -> dict:
    """{name: (pooled, x's gradient of Σ pooled·probe)} of ``global_avg_pool``
    and ``adaptive_avg_pool`` to (1, 1) bins of NHWC ``x``, under
    ``strips`` when given (``x`` is then the strip)."""
    out = {}
    for name, size in POOLS:
        xs = x.clone().requires_grad_()
        with strips if strips is not None else contextlib.nullcontext():
            y = ops.global_avg_pool(xs) if size is None else ops.adaptive_avg_pool(xs, size)
        (y * torch.as_tensor(probes[name])).sum().backward()
        out[name] = (y.detach(), xs.grad)
    return out


def refusals(strips) -> dict:
    """{the name an op gives itself: its error} under ``strips`` for each
    op that reads across rows and has no strip form, called on a small
    input (NCHW maps, NHWC for ``module/ops.py``'s functions, tokens for
    the attentions); 'returned' where one does not raise."""
    from ever_tpu_torch.module import context_block, efficientnet, freenet, resnet, se_block
    from ever_tpu_torch.module import vit
    x, tokens = torch.randn(1, 8, 4, 6), torch.randn(1, 5, 8)
    nhwc = x.permute(0, 2, 3, 1)
    cases = {
        'adaptive_avg_pool (bins (2, 3))': lambda: ops.adaptive_avg_pool(nhwc, (2, 3)),
        'downsample_bilinear': lambda: ops.downsample_bilinear(nhwc, (2, 3)),
        'resize (bilinear': lambda: ops.resize(nhwc, scale=2, method='bilinear'),
        'checkpointed': lambda: ops.checkpointed(nn.Identity(), lambda t: t, x),
        'GroupNorm2d': lambda: ops.GroupNorm2d(2, 8)(x),
        'the s2d stem': lambda: resnet.depth_to_space(x),
        'the SE squeeze': lambda: se_block.SEBlock(8, 4)(x),
        'the MBConv SE squeeze': lambda: efficientnet.MBConv(8, 8, 1)(x, True),
        'ContextBlock2d': lambda: context_block.ContextBlock2d(8)(x),
        'SpectralAttention': lambda: freenet.SpectralAttention(8)(x),
        'attention': lambda: vit.SelfAttention(8, 2)(tokens),
        'CausalSelfAttention': lambda: vit.CausalSelfAttention(8, 2)(tokens),
    }
    with strips:
        return {name: _raises(fn) for name, fn in cases.items()}


def ops_step(model, batch, mesh=None, steps=2):
    """``steps`` spatial steps of ``model`` (the unsharded step without a
    mesh): the metrics of each and the final state_dict."""
    from ever_tpu_torch.parallel.spmd import build_train_step
    sched, tx = _sgd()
    state = create_train_state(model, tx)
    step = (build_train_step(model, tx, sched, rng_seed=3) if mesh is None else
            spatial.build_spatial_train_step(model, tx, sched, mesh=mesh, rng_seed=3,
                                             device='cpu'))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}


def primitives_worker(rank, world, init, out):
    """On 4 ranks, each case twice: on a ``('data',)`` mesh of 4 and on the
    ``'data'`` axis of a ``('pair', 'data')`` mesh of (2, 2) (two lines of 2
    ranks, each holding the whole tile: replicas on ``'pair'``).  The halo
    primitives (values, ``crop_start`` and the input's gradient of a probe
    loss), ``spatial_partition_apply`` (both boundaries, halo 0, a one-rank
    axis), ``build_halo_train_step`` (both boundaries), two spatial steps
    of :class:`OpsNet` and the strips' :func:`pools`; results under ``{axis
    size: ...}``."""
    inp = _start(rank, world, init, out, 'prim')
    meshes = {4: tmesh.make_mesh(('data',)), 2: tmesh.make_mesh(('pair', 'data'), (2, 2))}
    one = tmesh.make_mesh(('data', 'one'), (world, 1))
    res = {}
    for k, mesh in meshes.items():
        res[k] = _primitives(inp, inp['cases'][k], mesh, mesh.rank('data'), k, one)
    _save(out, 'prim', rank, res)


def _primitives(inp, case, mesh, r, k, one):
    res = {}
    x = torch.from_numpy(case['x'])
    h = x.shape[1] // k
    halo = inp['halo']
    for name, fn in (('zeros', spatial.halo_exchange), ('exact', spatial.halo_exchange_exact)):
        xs = x[:, r * h:(r + 1) * h].clone().requires_grad_()
        with mesh:
            got = fn(xs, halo, 'data')
        padded, start = got if name == 'exact' else (got, None)
        (padded * torch.from_numpy(case['probes'][name][r])).sum().backward()
        res[name] = (padded.detach(), start, xs.grad)
    res['outside_mesh'] = _raises(lambda: spatial.halo_exchange(x, 1, 'data'))

    net = ConvStack(width=inp['width'], depth=inp['depth']).load_flax(inp['params'])
    tile = torch.from_numpy(inp['tile'])
    with torch.no_grad():
        for boundary, halo in inp['partition']:
            y = spatial.spatial_partition_apply(net, tile, mesh, 'data', halo, boundary,
                                                device='cpu')
            res['partition', boundary, halo] = (type(y).__name__, y.to_local())
        y = spatial.spatial_partition_apply(net, tile, one, 'one', 4, device='cpu')
        res['one_rank'] = (type(y).__name__, y)

    for boundary in ('exact', 'zeros'):
        stack = ConvStack(width=inp['width'], depth=inp['depth']).load_flax(inp['params'])
        params = dict(stack.named_parameters())
        factory, _ = tbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
        tx = factory.build(0.05)
        step = spatial.build_halo_train_step(
            lambda p, t: torch.func.functional_call(stack, p, (t,)), mse, tx, mesh,
            halo=inp['train_halo'], boundary=boundary, device='cpu')
        (it, params, _), metrics = step((0, params, tx.init(params.items())),
                                        (inp['train_x'], inp['train_y']))
        res['halo_step', boundary] = (it, float(metrics['total_loss']),
                                      {k: v.detach().clone() for k, v in params.items()},
                                      dict(step.stats))

    model = OpsNet().double()
    model.load_state_dict(inp['ops_state'])
    res['ops'] = ops_step(model, (inp['ops_x'], inp['ops_y']), mesh)
    px = torch.from_numpy(inp['pool_x'])
    ph = px.shape[1] // k
    res['pools'] = pools(px[:, r * ph:(r + 1) * ph], inp['pool_probes'],
                         spatial.Strips(mesh, 'data'))
    res['refusals'] = refusals(spatial.Strips(mesh, 'data'))
    return res


@contextlib.contextmanager
def float32_parts_in_float64():
    """While entered, ``torch.float32`` names float64 and ``Tensor.float``
    keeps a float64 tensor float64 in this process, so that every part of
    FarSeg's float64 step that computes in float32 (the bilinear resizes,
    the relation's channel sum, the logits and the loss, the global pool's
    sum, K8's plain version) computes in float64: the experiment that shows
    the spatial step's gap to the unsharded step to be those parts'
    rounding (``tests/test_torch_spatial_train.py``)."""
    f32, to_float = torch.float32, torch.Tensor.float

    def float64_kept(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else to_float(self, *args, **kwargs)

    torch.float32, torch.Tensor.float = torch.float64, float64_kept
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float = f32, to_float


VARIANTS = (('as_is', contextlib.nullcontext), ('float64', float32_parts_in_float64))


def farseg_worker(rank, world, init, out):
    """The narrow FarSeg-R18 (float64, K8's plain version at the stem) over
    ``world`` strips: one spatial step as the model is and one with its
    float32 parts in float64 (:func:`float32_parts_in_float64`), each
    step's metrics, state and hops; JAX's batch errors and the
    stride-alignment error; then the unsharded step on the whole tile from
    the same weights, as the model is on rank 0 and with the float32 parts
    in float64 on rank 1."""
    inp = _start(rank, world, init, out, 'farseg')
    mesh = tmesh.make_mesh(('data',))
    model = tbuilder.make_model({'type': 'FarSeg', 'params': inp['cfg']}, device='cpu').double()
    model.load_state_dict(inp['state_dict'])
    sched, tx = _sgd()
    x, y = inp['x'], inp['y']
    res = {}
    for variant, ctx in VARIANTS:
        net = copy.deepcopy(model)
        with ctx():
            step = spatial.build_spatial_train_step(net, tx, sched, mesh=mesh, device='cpu')
            state, metrics = step(create_train_state(net, tx), (x, y))
        res[variant] = dict(metrics={k: float(v) for k, v in metrics.items()}, step=state.step,
                            state={k: v.clone() for k, v in net.state_dict().items()},
                            stats=dict(step.stats))
        if variant == 'as_is':
            res['indivisible'] = _raises(lambda: step(state, (x[:, :-2], y[:, :-2])))
            res['rank1'] = _raises(lambda: step(state, (x, y, x[0, 0, 0])))
    fresh = copy.deepcopy(model)
    bad = spatial.build_spatial_train_step(fresh, tx, sched, mesh=mesh, device='cpu')
    rows = inp['misaligned']
    res['misaligned'] = _raises(lambda: bad(create_train_state(fresh, tx),
                                            (x[:, :rows], y[:, :rows])))
    if rank < len(VARIANTS):            # the port's unsharded step on the whole tile
        from ever_tpu_torch.parallel.spmd import build_train_step
        variant, ctx = VARIANTS[rank]
        with ctx():
            _, m = build_train_step(model, tx, sched)(create_train_state(model, tx),
                                                      (torch.from_numpy(x), torch.from_numpy(y)))
        res['unsharded'] = (variant, {k: float(v) for k, v in m.items()}, model.state_dict())
    _save(out, 'farseg', rank, res)
