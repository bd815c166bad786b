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


PYRAMID_BINS = (2, 3, 6)
# (name, output whole on every rank): the strip forms of the reductions over
# the tile, each called by strip_forms; the pyramid cases are the pooled
# map (whole) and its upsample back to the strips, half-pixel and with
# align_corners
STRIP_FORMS = (('GroupNorm2d', False), ('the SE squeeze', False),
               ('the MBConv SE squeeze', False), ('ContextBlock2d att', False),
               ('ContextBlock2d avg', False), ('PoolBlock (bins 3)', False)) + tuple(
    case for b in PYRAMID_BINS for case in ((f'adaptive_avg_pool (bins {b})', True),
                                             (f'pyramid upsample (bins {b})', False),
                                             (f'pyramid upsample (bins {b}, corners)', False)))


def strip_form_modules() -> dict:
    """The modules of :func:`strip_forms`, float64, with every parameter
    drawn from one seed (the context block's zero-initialised expand convs
    too, so that its pool reaches the output): the same in every process."""
    from ever_tpu_torch.module import context_block, efficientnet, se_block
    torch.manual_seed(5)
    mods = {'GroupNorm2d': ops.GroupNorm2d(4, 8),
            'the SE squeeze': se_block.SEBlock(8, 4),
            'the MBConv SE squeeze': efficientnet.MBConv(8, 8, 1),
            'ContextBlock2d att': context_block.ContextBlock2d(
                8, 1 / 4, 'att', ('channel_add', 'channel_mul')),
            'ContextBlock2d avg': context_block.ContextBlock2d(
                8, 1 / 4, 'avg', ('channel_add', 'channel_mul')),
            'PoolBlock (bins 3)': ops.PoolBlock(8, 3, 4)}
    with torch.no_grad():
        for m in mods.values():
            for t in m.parameters():
                t.normal_(0.0, 0.5)
    return {k: m.double() for k, m in mods.items()}


def strip_forms(x: torch.Tensor, probes: dict, mesh=None) -> dict:
    """{name: (output, x's gradient of Σ output·probe)} of each of
    ``STRIP_FORMS`` on NCHW ``x``: the whole tile without ``mesh``, else
    this rank's strip under the strip context of ``mesh``'s ``'data'``
    axis (and its mesh view, whose batch axis the train-mode BatchNorms
    reduce over), with its rows of the probe where the output is a strip
    and the whole probe where it is whole."""
    mods = strip_form_modules()
    if mesh is None:
        ctx, rows = contextlib.nullcontext, slice(None)
    else:
        h, s = x.shape[2], mesh.rank('data')
        rows = slice(s * h, (s + 1) * h)

        @contextlib.contextmanager
        def ctx():
            with mesh.with_batch_axes(('data',)), spatial.Strips(mesh, 'data'):
                yield

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    def pyramid(b, corners=None):
        def fn(t):
            pooled = ops.adaptive_avg_pool(nhwc(t), b).permute(0, 3, 1, 2)
            if corners is None:
                return pooled
            return ops.bilinear_nchw(pooled, t.shape[2:], corners, whole=True)
        return fn

    calls = {'the MBConv SE squeeze': lambda t: mods['the MBConv SE squeeze'](t, True),
             'PoolBlock (bins 3)': lambda t: mods['PoolBlock (bins 3)'](t, True)}
    for b in PYRAMID_BINS:
        calls[f'adaptive_avg_pool (bins {b})'] = pyramid(b)
        calls[f'pyramid upsample (bins {b})'] = pyramid(b, False)
        calls[f'pyramid upsample (bins {b}, corners)'] = pyramid(b, True)
    out = {}
    for name, is_whole in STRIP_FORMS:
        fn = calls.get(name) or mods[name]
        xs = x.clone().requires_grad_()
        with ctx():
            y = fn(xs)
        probe = torch.as_tensor(probes[name])
        (y * (probe if is_whole else probe[:, :, rows])).sum().backward()
        out[name] = (y.detach(), xs.grad)
    return out


def refusals(strips) -> dict:
    """{the name an op gives itself: its error} under ``strips`` for each
    op whose strip output would not be its share of the whole tile's, on a
    strip of 3 rows (NCHW maps, NHWC for ``module/ops.py``'s functions):
    a bilinear halving (3 rows to 1 a strip, the tile's 3·k to 3·k/2), a
    narrow FreeNet's 2×2/2 max pool, a folded (s2d) input of 3 rows a
    strip beside labels of 6, a 3×3/2 conv; 'returned' where one does not
    raise."""
    from ever_tpu_torch.module import freenet
    torch.manual_seed(0)
    x = torch.randn(1, 8, 3, 6)
    nhwc = x.permute(0, 2, 3, 1)
    net = freenet.FreeNet(dict(in_channels=8, stage_channels=(4, 4), classes=2))
    cases = {
        'resize': lambda: ops.resize(nhwc, scale=0.5, method='bilinear'),
        'max_pool': lambda: net(nhwc),
        'the s2d stem': lambda: strips.check_batch((torch.zeros(1, 3, 4, 12),
                                                    torch.zeros(1, 6, 8))),
        'Conv2d': lambda: ops.Conv2d(8, 8, 3, stride=2)(x),
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
    fx = torch.from_numpy(inp['form_x'])
    fh = fx.shape[2] // k
    res['strip_forms'] = strip_forms(fx[:, :, r * fh:(r + 1) * fh], inp['form_probes'], mesh)
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
# ResNet-18's stem, blocks and widths with one block a stage, as
# tests/test_torch_factseg.py registers it in both packages
TINY_TRUNK = 'resnet_basic_tiny'
# the models through the strip forms, each trained as FarSeg-R18 is (one
# step over the strips, one on the whole tile): FarSeg++ (its weights from
# the JAX model, saved by the test), FarSeg on an SE + GC trunk and
# PSPNet (seeded here, seeded_init); the rank that runs each one's
# unsharded step
MORE_MODELS = (('farseg_pp', 2), ('se_gc', 3), ('pspnet', 1))


def register_tiny_trunk() -> None:
    from ever_tpu_torch.module import resnet as tres
    tres.RESNET_SPECS[TINY_TRUNK] = (tres.BasicBlock, (1, 1, 1, 1), 1, 64, False)


class PSPNet(nn.Module):
    """A narrow PSPNet as a user composes it: ``ResNetEncoder`` at output
    stride 8 (K8's route at the stem), ``PPMHead`` (bins 1, 2, 3, 6) on C5,
    float32 logits and the cross-entropy."""

    def __init__(self, classes: int, dtype: str = 'float64'):
        super().__init__()
        from ever_tpu_torch.core import registry
        self.encoder = registry.MODEL['ResNetEncoder'](dict(
            resnet_type=TINY_TRUNK, output_stride=8, maxpool_impl='pallas', dtype=dtype))
        self.head = registry.MODEL['PPMHead'](dict(
            ppm=dict(in_channels=512, pool_channels=8, out_channels=16, bins=(1, 2, 3, 6)),
            num_classes=classes, dtype=dtype))

    def forward(self, x, y=None, train=False, generator=None):
        logits = self.head(self.encoder(x, train)[-1], train, generator)
        logits = logits.permute(0, 2, 3, 1).float()
        return dict(cls_loss=L.softmax_ce_loss_with_logits(logits, y, ignore_index=255))


def seeded_init(model: nn.Module, seed: int) -> nn.Module:
    """Seeded weights, the same in every process: kernels ~N(0, 2/fan_in),
    norm weights ~N(1, 0.1²), biases ~N(0, 0.02²) (a GC block's
    zero-initialised expand convs too, so that its pool's gradient flows
    in the first step)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=gen, dtype=torch.float64)
            if p.dim() >= 2:
                p.copy_((2.0 / p[0].numel()) ** 0.5 * draw)
            else:
                p.copy_(1.0 + 0.1 * draw if name.endswith('weight') else 0.02 * draw)
    return model


def more_model(name: str, inp: dict) -> nn.Module:
    """One of ``MORE_MODELS``, float64, with its weights."""
    if name == 'pspnet':
        return seeded_init(PSPNet(inp['classes']).double(), 7)
    model = tbuilder.make_model({'type': 'FarSeg', 'params': inp[f'{name}_cfg']},
                                device='cpu').double()
    if name == 'farseg_pp':
        model.load_state_dict(inp['farseg_pp_state_dict'])
        return model
    return seeded_init(model, 8)


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
    register_tiny_trunk()
    for name, _ in MORE_MODELS:
        for variant, ctx in VARIANTS:
            net = more_model(name, inp)
            with ctx():
                step = spatial.build_spatial_train_step(net, tx, sched, mesh=mesh, device='cpu')
                state, metrics = step(create_train_state(net, tx), (x, y))
            res[name if variant == 'as_is' else f'{name}/{variant}'] = dict(
                metrics={k: float(v) for k, v in metrics.items()}, step=state.step,
                state={k: v.clone() for k, v in net.state_dict().items()},
                stats=dict(step.stats))
    # the port's unsharded steps on the whole tile, spread over the ranks
    from ever_tpu_torch.parallel.spmd import build_train_step
    whole = (torch.from_numpy(x), torch.from_numpy(y))
    res['unsharded'] = []
    if rank < len(VARIANTS):
        variant, ctx = VARIANTS[rank]
        with ctx():
            _, m = build_train_step(model, tx, sched)(create_train_state(model, tx), whole)
        res['unsharded'].append((variant, {k: float(v) for k, v in m.items()},
                                 model.state_dict()))
    for name, on in MORE_MODELS:
        if on == rank:
            for variant, ctx in VARIANTS:
                net = more_model(name, inp)
                with ctx():
                    _, m = build_train_step(net, tx, sched)(create_train_state(net, tx), whole)
                res['unsharded'].append((name if variant == 'as_is' else f'{name}/{variant}',
                                         {k: float(v) for k, v in m.items()}, net.state_dict()))
    _save(out, 'farseg', rank, res)
