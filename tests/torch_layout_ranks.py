"""The rank side of ``tests/test_torch_{tp,mesh,pp,ep}.py``: each worker runs
in a gloo rank on the CPU, reads the inputs and weights its test saved
(``{job}-inputs.pt``), runs the port's layouts and saves what each rank
computed (``{job}-rank{r}.pt``).  No JAX here: the ranks start without
it."""

import os

import torch

from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import dist
from ever_tpu_torch.core.checkpoint import CheckPoint
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel import pp, tp
from ever_tpu_torch.parallel.ep import MoEMlp
from ever_tpu_torch.parallel.sharded import create_train_state_sharded
from ever_tpu_torch.parallel.spmd import TrainState, build_train_step, sown_losses
from ever_tpu_torch.parallel.zero import full_state_dict, local_bytes


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


def probe_loss(out, probes):
    """``Σ x_norm_clstoken·u + Σ x_norm_patchtokens·v`` for the fixed random
    ``probes`` (u, v): a loss whose gradients reach every parameter.  The
    JAX tests' ``mean(x_norm_clstoken²)`` of a final LayerNorm with unit
    scale and zero shift is constant (a normalised row's mean square is 1),
    so its gradients are rounding noise."""
    u, v = (torch.from_numpy(p) for p in probes)
    return (out['x_norm_clstoken'] * u).sum() + (out['x_norm_patchtokens'] * v).sum()


def tp_worker(rank, world, init, out):
    """Tensor parallel on a (1, 2) mesh: the trunk's output and its
    gradients (gathered), the bytes each rank holds of the split leaves."""
    inp = _start(rank, world, init, out, 'tp')
    mesh = tmesh.make_mesh(('data', 'model'), (1, 2))
    vit = tvit.DinoVisionTransformer(**inp['cfg'])
    vit.load_state_dict(inp['state_dict'])
    whole = {n: p.numel() * p.element_size() for n, p in vit.named_parameters()}
    tp.apply_tp(vit, mesh, device='cpu')
    x = torch.from_numpy(inp['x']).requires_grad_()
    res = vit(x)
    loss = probe_loss(res, inp['probes'])
    loss.backward()
    grads = tp.gather_tp(vit, {n: p.grad for n, p in vit.named_parameters()})
    plan = tp.tp_plan(vit)
    _save(out, 'tp', rank, dict(
        out={k: v.detach() for k, v in res.items() if k != 'grid'}, loss=loss.item(),
        x_grad=x.grad, grads=grads, sharded=sorted(plan.sharded),
        local={n: p.numel() * p.element_size() for n, p in vit.named_parameters()},
        whole=whole, again=_raises(lambda: tp.apply_tp(vit, mesh, device='cpu')),
        qkv_rows=vit.blocks[0].attn.qkv_rows.tolist(),
        evaluate=tp_evaluation(out, rank, mesh, inp['eval'])))


def tp_evaluation(out, rank, mesh, spec) -> tuple:
    """C.5: a DinoSeg (the ``spec`` trunk) under tensor parallel on the
    mesh, evaluated through a ``Launcher`` by
    ``distributed_evaluate_pixel_prediction_task``: ('raised', the error's
    message), or ('ok', ...) where it computes."""
    from torch_zero_ranks import distributed_evaluation
    from ever_tpu_torch.core.launcher import Launcher

    name, shape, classes, x, y = spec
    tvit.VIT_SPECS[name] = shape
    torch.manual_seed(0)
    model = tbuilder.make_model({'type': 'DinoSeg', 'params': dict(
        backbone=dict(name=name), classes=classes)}, device='cpu')
    tp.apply_tp(model, mesh, device='cpu')
    launcher = Launcher(os.path.join(out, f'tp-eval{rank}'), model, None, device='cpu',
                        mesh=mesh)
    launcher._state = TrainState(step=0, model=model, optimizer=None)
    return distributed_evaluation(launcher, x, y)


def _groups_seen(mesh, axes):
    """Each axis's line as the ranks' ids summed over its group."""
    seen = {}
    for axis in axes:
        t = torch.tensor([float(dist.get_rank())])
        group = mesh.axis_group(axis)
        if group is not None:
            torch.distributed.all_reduce(t, group=group)
        seen[axis] = (t.item(), mesh.rank(axis), mesh.axis_ranks(axis))
    return seen


def mesh_worker(rank, world, init, out):
    """A (2, 2) mesh's axis groups, the hybrid meshes, and two steps of
    DinoSeg under tensor parallel with ZeRO-3 (SGD with momentum and a
    clip), each data rank on its half of the batch, the state after the
    first written as directories and resumed from them."""
    inp = _start(rank, world, init, out, 'mesh')
    res = {}
    mesh = tmesh.make_mesh(('data', 'model'), (2, 2))
    res['groups'] = _groups_seen(mesh, ('data', 'model'))
    res['batch'] = (mesh.batch_axes, mesh.rank(), mesh.size())
    one = tmesh.make_hybrid_mesh(('data', 'model'), (2, 2))
    res['hybrid_one_node'] = (one.axis_names, one.shape, one.batch_axes, one.size())
    os.environ['LOCAL_WORLD_SIZE'] = '2'
    try:
        two = tmesh.make_hybrid_mesh(('data',))
    finally:
        del os.environ['LOCAL_WORLD_SIZE']
    res['hybrid_two_nodes'] = (two.shape, two.rank('replica'), two.rank(), two.size(),
                               _groups_seen(two, ('replica', 'data')))
    res['bad_shape'] = _raises(lambda: tmesh.make_mesh(('data', 'model'), (3, 2)))

    tvit.VIT_SPECS[inp['spec'][0]] = inp['spec'][1]
    factory, _ = tbuilder.make_optimizer(dict(type='sgd', params=dict(momentum=0.9)))
    tx = factory.build(inp['lr'], grad_clip=dict(max_norm=inp['max_norm']))

    def sharded_state():
        model = tbuilder.make_model(inp['cfg'], device='cpu')
        model.load_state_dict(inp['state_dict'])
        state, sh = create_train_state_sharded(model, tx, mesh=mesh, level=3, tp_axis='model',
                                               min_shard_bytes=inp['min_shard_bytes'],
                                               device='cpu')
        return state, sh, build_train_step(model, tx, None, mesh=mesh, state_shardings=sh)

    state, sh, step = sharded_state()
    x, y = inp['x'], inp['y']
    rows = slice(mesh.rank() * len(x) // 2, (mesh.rank() + 1) * len(x) // 2)
    state, metrics = step(state, (x[rows], y[rows]))
    res['metrics'] = {k: float(v) for k, v in metrics.items()}
    res['state'] = full_state_dict(state)
    res['specs'] = {n: tuple(s.spec) for n, s in sh.params.items()}
    res['bytes'] = local_bytes(state)
    # the state after one step as directories, then the unbroken second step
    CheckPoint.save_sharded(os.path.join(out, 'mesh-sharded'), state)
    for backend in ('orbax', 'orbax_async'):
        ckpt = CheckPoint(_Host(os.path.join(out, f'mesh-{backend}'), state), backend)
        ckpt.set_global_step(1)
        ckpt.save()
        ckpt.wait()
    state, metrics = step(state, (x[rows], y[rows]))
    res['unbroken'] = ({k: float(v) for k, v in metrics.items()}, full_state_dict(state))
    for how in ('sharded', 'orbax'):
        fresh, _, fresh_step = sharded_state()
        if how == 'sharded':
            CheckPoint.restore_sharded(os.path.join(out, 'mesh-sharded'), fresh)
        else:
            CheckPoint(_Host(os.path.join(out, 'mesh-orbax'), fresh), 'orbax').try_resume()
        at = fresh.step
        fresh, metrics = fresh_step(fresh, (x[rows], y[rows]))
        res[f'resumed/{how}'] = (at, {k: float(v) for k, v in metrics.items()},
                                 full_state_dict(fresh))
    _save(out, 'mesh', rank, res)


class _Host:
    """The launcher side a ``CheckPoint`` reads: its model dir, state and
    the step it restores."""
    logger = None
    device = torch.device('cpu')

    def __init__(self, model_dir, state):
        os.makedirs(model_dir, exist_ok=True)
        self.model_dir, self.state = model_dir, state

    def restore_state(self, model_state, opt_state, global_step):
        self.state.step = int(global_step)


class _Tanh(torch.nn.Module):
    def forward(self, w, h):
        return torch.tanh(h @ w)


def pp_worker(rank, world, init, out):
    """The GPipe primitive and ``pipelined_vit_apply`` on 4 stages and on a
    ('data', 'pipe') mesh of (2, 2): values and input gradients; each
    stage's blocks; the divisibility errors."""
    inp = _start(rank, world, init, out, 'pp')
    res = {}
    layer = _Tanh()
    vit = tvit.DinoVisionTransformer(**inp['cfg'])
    for name, axes, shape in (('pipe4', ('pipe',), (4,)), ('data_pipe', ('data', 'pipe'), (2, 2))):
        mesh = tmesh.make_mesh(axes, shape)
        stages, s = mesh.axis_size('pipe'), mesh.rank('pipe')
        ws = torch.from_numpy(inp['ws'])
        per = len(ws) // stages
        xs = torch.from_numpy(inp['xs']).requires_grad_()
        with mesh:
            got = pp.pipeline(layer, ws[s * per:(s + 1) * per], xs)
        got.sum().backward()
        res[f'{name}/primitive'] = (got.detach(), xs.grad)

        fn = pp.pipelined_vit_apply(vit, inp['state_dict'], mesh, device='cpu')
        x = torch.from_numpy(inp['x'])
        d, n_data = mesh.rank(), mesh.size()
        x = x[d * len(x) // n_data:(d + 1) * len(x) // n_data].clone().requires_grad_()
        got = fn(x)
        u, v = inp['probes']
        rows = slice(d * len(u) // n_data, (d + 1) * len(u) // n_data)
        probe_loss(got, (u[rows], v[rows])).backward()
        res[f'{name}/vit'] = dict(
            out={k: v.detach() for k, v in got.items() if k != 'grid'}, x_grad=x.grad,
            grads={k: p.grad for k, p in fn.named_parameters()},
            blocks=sorted({int(k.split('.')[1]) for k, _ in fn.named_parameters()
                           if k.startswith('blocks.')}), stats=dict(fn.stats))
        res[f'{name}/batch_error'] = _raises(lambda: fn(x[:1].repeat(3, 1, 1, 1)))
    mesh = tmesh.make_mesh(('pipe',), (4,))
    name, spec = inp['short']
    tvit.VIT_SPECS[name] = spec
    short = tvit.DinoVisionTransformer(**{**inp['cfg'], 'vit_type': name})
    res['depth_error'] = _raises(lambda: pp.pipelined_vit_apply(short, None, mesh, device='cpu'))
    mesh = tmesh.make_mesh(('data', 'pipe'), (2, 2))
    fn = pp.pipelined_vit_apply(vit, inp['state_dict'], mesh, num_microbatches=2, device='cpu')
    res['data_error'] = _raises(lambda: fn(torch.from_numpy(inp['x'][:1])))
    _save(out, 'pp', rank, res)


def ep_worker(rank, world, init, out):
    """``MoEMlp`` over a 2-rank ``'expert'`` axis: output, the sown
    auxiliary loss, and the gradients of ``sum(y²) + aux``."""
    inp = _start(rank, world, init, out, 'ep')
    mesh = tmesh.make_mesh(('expert',), (2,))
    moe = MoEMlp(**inp['kwargs'], device='cpu')
    moe.load_state_dict(inp['state_dict'])
    moe.shard_experts(mesh)
    x = torch.from_numpy(inp['x']).requires_grad_()
    with sown_losses() as sown:
        y = moe(x)
    aux = sown['moe_aux_loss'][0]
    ((y ** 2).sum() + aux).backward()
    from ever_tpu_torch.core.launcher import Launcher
    launcher = Launcher(os.path.join(out, f'ep-launcher{rank}'), moe, None, device='cpu',
                        mesh=mesh)
    launcher._state = TrainState(step=0, model=moe, optimizer=None)
    _save(out, 'ep', rank, dict(
        y=y.detach(), aux=aux.item(), x_grad=x.grad, first=moe.first_expert,
        grads={n: p.grad for n, p in moe.named_parameters()},
        shapes={n: tuple(p.shape) for n, p in moe.named_parameters()},
        local_state=_raises(launcher.local_state)))
