"""The port's data-parallel layer over real processes, on the CPU.

One job of two gloo ranks (``file://`` rendezvous under the test's
``tmp_path``, so that concurrent test workers never share a port) runs every
piece once and saves what each rank computed; the tests hold it against one
process on the whole batch and, where the JAX package has the function,
against the JAX package:

- the process helpers (``all_gather``, ``gather``, ``reduce_loss_dict``,
  ``broadcast_one_to_all``) with the semantics the JAX package's
  ``tools/multiprocess_validation.py`` asserts;
- ``BatchNorm2d`` in train mode inside ``with mesh:`` (global statistics),
  2 samples a rank and 1 a rank, in float64;
- the cross-entropy, dice, BCE, Tversky, OHEM, label-smoothing, normalised
  focal losses and ``dice_coeff`` with uneven ignored pixels across the
  ranks (the global value, which a plain average of the ranks' means is
  not);
- the drop-path draws;
- ``tiled_inference(mesh=)``.

Every launch runs under a timeout that kills its ranks, so a hung
collective fails one test instead of the suite.
"""

import os
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.magic.tiled import tiled_inference as jax_tiled
from ever_tpu.module import loss as jloss
from ever_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ever_tpu_torch.core import dist
from ever_tpu_torch.magic.tiled import tiled_inference as torch_tiled
from ever_tpu_torch.module import loss as tloss
from ever_tpu_torch.module.ops import BatchNorm2d
from ever_tpu_torch.module.vit import drop_path_mask
from ever_tpu_torch.parallel.mesh import make_mesh
from test_torch_tiled import K, _scene, jax_predict, torch_predict

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 2


class _Ranks:
    """Processes of one job: :meth:`finish` waits for them."""

    def __init__(self, procs, logs):
        self.procs, self.logs = procs, logs

    def kill(self) -> None:
        """Kill the ranks still running and close their logs (a job whose
        results no test read)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()

    def finish(self, timeout: float = 180) -> None:
        """Wait up to ``timeout`` seconds in all, kill the ranks still
        running, and fail with every rank's log unless all exited 0."""
        try:
            for p in self.procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = []
        for r, f in enumerate(self.logs):
            f.seek(0)
            text.append(f'--- rank {r} (exit {self.procs[r].returncode}) ---\n{f.read()[-4000:]}')
            f.close()
        assert all(p.returncode == 0 for p in self.procs), '\n'.join(text)


def start_ranks(module: str, fn: str, world: int, tmp_path, *args) -> _Ranks:
    """Start ``module.fn(rank, world, init_method, *args)`` (``module`` under
    ``tests/``) in ``world`` fresh processes that rendezvous through a file
    under ``tmp_path``."""
    init = f'file://{tmp_path}/rendezvous-{uuid.uuid4().hex}'
    code = (f'import sys; sys.path[:0] = [{REPO!r}, {TESTS!r}]; import {module}; '
            f'{module}.{fn}(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    logs = [open(tmp_path / f'{fn}-rank{r}.log', 'w+') for r in range(world)]
    procs = [subprocess.Popen([sys.executable, '-c', code, str(r), str(world), init,
                               *map(str, args)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    return _Ranks(procs, logs)


def run_ranks(module: str, fn: str, world: int, tmp_path, *args, timeout: float = 180):
    """:func:`start_ranks`, then wait: a rank that exits non-zero, or a job
    that outlives ``timeout`` seconds (its ranks are killed), fails the
    test with the ranks' logs."""
    start_ranks(module, fn, world, tmp_path, *args).finish(timeout)


# -- inputs -----------------------------------------------------------------------

BN_CASES = {'2 a rank': 4, '1 a rank': 2}
CLASSES = 4


def _bn_inputs(n):
    """x [n, 3, 5, 4] float64 around per-channel means of 10, -3 and 0.5
    (the combine must not cancel large sums of squares), dy, γ, β."""
    rng = np.random.default_rng(n)
    scale, shift = np.array([2.0, 0.5, 1.0]), np.array([10.0, -3.0, 0.5])
    x = rng.normal(size=(n, 3, 5, 4)) * scale[:, None, None] + shift[:, None, None]
    dy = rng.normal(size=x.shape)
    return x, dy, rng.uniform(0.5, 1.5, 3), rng.normal(size=3)


def _bn(gamma, beta):
    bn = BatchNorm2d(3).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.uniform_(-1, 1, generator=torch.Generator().manual_seed(0))
    return bn


def _loss_inputs():
    """Logits [4, 6, 5, 4] float64 and labels with most of rank 0's pixels
    ignored and few of rank 1's: the ranks' valid counts differ."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(4, 6, 5, CLASSES)) * 2
    labels = rng.integers(0, CLASSES, size=(4, 6, 5))
    frac = np.array([0.7, 0.6, 0.05, 0.0])[:, None, None]
    labels[rng.random(labels.shape) < frac] = 255
    return logits, labels


TILED = [dict(h=200, w=150, k=64, stride=48, tile_batch=5, tta=None),   # 12 tiles: 10 + 2
         dict(h=96, w=80, k=64, stride=32, tile_batch=2, tta='d4')]     # 4 tiles: 2 + 2


def _rank_slice(a, rank, world):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _worker(rank, world, init, out):
    """One rank's share of every check; writes ``rank{rank}.pt`` to ``out``."""
    torch.set_num_threads(1)
    dist.init_dist_env(init, world, rank, backend='gloo')
    dist.init_dist_env(init, world, rank, backend='gloo')       # a no-op now
    res = dict(world=dist.get_world_size(), rank=dist.get_rank())
    res['all_gather'] = dist.all_gather({'rank': float(rank)})
    res['gather'] = dist.gather(10 * rank, dst=1)
    res['reduce'] = dist.reduce_loss_dict({'l': float(rank), 'm': torch.tensor(2.0 * rank)})
    res['broadcast'] = dist.broadcast_one_to_all(np.asarray([42.0 + rank]))
    t = torch.tensor([7.0 + rank])
    res['broadcast_tensor'] = dist.broadcast_one_to_all(t).clone()
    dist.synchronize()
    mesh = make_mesh()
    res['mesh'] = (mesh.size(), mesh.shape, mesh.rank())

    for name, n in BN_CASES.items():
        x, dy, gamma, beta = _bn_inputs(n)
        bn = _bn(gamma, beta)
        xr = torch.from_numpy(_rank_slice(x, rank, world)).requires_grad_()
        with mesh:
            y = bn(xr, train=True)
        y.backward(torch.from_numpy(_rank_slice(dy, rank, world)))
        res[f'bn {name}'] = dict(y=y.detach(), dx=xr.grad, dgamma=bn.weight.grad,
                                 dbeta=bn.bias.grad, mean=bn.running_mean.clone(),
                                 var=bn.running_var.clone())

    logits, labels = _loss_inputs()
    for name, fn, kw in (('ce', tloss.softmax_ce_loss_with_logits, {}),
                         ('dice', tloss.dice_loss_with_logits, {}),
                         ('dice axis', tloss.dice_loss_with_logits, dict(axis_name='data')),
                         ('bce', _bce(tloss), {}),
                         *((k, f, {}) for k, f in _more_losses(tloss, _torch_ops).items())):
        lr = torch.from_numpy(_rank_slice(logits, rank, world)).requires_grad_()
        with mesh:
            value = fn(lr, torch.from_numpy(_rank_slice(labels, rank, world)), **kw)
        value.backward()
        res[name] = dict(value=value.detach(), grad=lr.grad)

    gen = torch.Generator().manual_seed(3)
    with mesh:
        res['drop'] = [drop_path_mask(3, 0.4, gen) for _ in range(2)]
    res['drop_after'] = torch.rand(2, generator=gen)

    for i, case in enumerate(TILED):
        res[f'tiled {i}'] = torch_tiled(
            torch_predict, _scene(case['h'], case['w']), case['k'], case['stride'], K,
            tile_batch=case['tile_batch'], tta=case['tta'], mesh=mesh, device='cpu')
    torch.save(res, os.path.join(out, f'rank{rank}.pt'))


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dist')
    run_ranks('test_torch_dist', '_worker', WORLD, tmp, tmp)
    return [torch.load(tmp / f'rank{r}.pt', weights_only=False) for r in range(WORLD)]


# -- process helpers ---------------------------------------------------------------

def test_process_helpers_over_two_ranks(ranks):
    """all_gather in rank order on every rank, gather on its dst only,
    reduce_loss_dict's mean on rank 0, broadcast of rank 0's value (host
    object and tensor), and the data mesh over both ranks."""
    for r, res in enumerate(ranks):
        assert (res['world'], res['rank']) == (WORLD, r)
        assert res['all_gather'] == [{'rank': 0.0}, {'rank': 1.0}]
        assert res['gather'] == ([0, 10] if r == 1 else [])
        assert float(res['broadcast'][0]) == 42.0
        assert float(res['broadcast_tensor'][0]) == 7.0
        assert res['mesh'] == (WORLD, {'data': WORLD}, r)
    assert ranks[0]['reduce'] == {'l': 0.5, 'm': 1.0}
    assert float(ranks[1]['reduce']['l']) == 1.0          # rank 1 keeps its own
    assert dist.get_world_size() == 1 and dist.gather(3) == [3]   # one process
    assert dist.get_local_device_count() == 1 and dist.get_global_device_count() == 1
    assert dist.reduce_loss_dict({'l': 2.0}) == {'l': 2.0}
    assert make_mesh().size() == 1 and make_mesh().group is None


# -- BatchNorm ----------------------------------------------------------------------

@pytest.mark.parametrize('name', BN_CASES)
def test_batchnorm_uses_global_statistics(ranks, name):
    """Train mode inside ``with mesh:``: y and dx of each rank equal one
    process's on the whole batch, the ranks' dγ and dβ sum to its (the step's
    DDP reduces them with the other gradients), and the running statistics
    (global mean and biased variance) are its on both ranks; float64, 1e-12."""
    x, dy, gamma, beta = _bn_inputs(BN_CASES[name])
    bn = _bn(gamma, beta)
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt, train=True)
    y.backward(torch.from_numpy(dy))
    for r, res in enumerate(ranks):
        got = res[f'bn {name}']
        for key, want in (('y', y.detach()), ('dx', xt.grad)):
            np.testing.assert_allclose(got[key].numpy(), _rank_slice(want.numpy(), r, WORLD),
                                       rtol=0, atol=1e-12, err_msg=f'{r} {key}')
        for key, want in (('mean', bn.running_mean), ('var', bn.running_var)):
            np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=0, atol=1e-12,
                                       err_msg=f'{r} {key}')
    for key, want in (('dgamma', bn.weight.grad), ('dbeta', bn.bias.grad)):
        total = sum(res[f'bn {name}'][key] for res in ranks)
        np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=0, atol=1e-12, err_msg=key)


def test_batchnorm_with_one_rank_is_the_one_process_path():
    """A mesh of one process changes nothing: the same bits as no mesh."""
    x, dy, gamma, beta = _bn_inputs(4)
    outs = []
    for mesh in (None, make_mesh()):
        bn = _bn(gamma, beta)
        xt = torch.from_numpy(x).requires_grad_()
        if mesh is None:
            y = bn(xt, train=True)
        else:
            with mesh:
                y = bn(xt, train=True)
        y.backward(torch.from_numpy(dy))
        outs.append([y, xt.grad, bn.weight.grad, bn.running_var])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- losses ---------------------------------------------------------------------------

def _bce(losses):
    """The masked BCE of channel 0 of the logits against ``labels > 0``,
    the ignored pixels kept ignored."""
    def fn(logits, labels):
        return losses.binary_cross_entropy_with_logits(
            logits[..., 0], (labels > 0) * 1.0 + (labels == 255) * 254.0)
    return fn


def _more_losses(losses, ops):
    """Tversky, OHEM, the label-smoothing losses, the normalised focal loss
    and ``dice_coeff``, as ``fn(logits, labels)`` of either package's loss
    module; ``ops`` gives the package's softmax and arange."""
    softmax, arange = ops

    def dice_coeff(logits, labels):
        c = logits.shape[-1]
        y = labels.reshape(-1)
        onehot = (y[:, None] == arange(c)) * 1.0
        return 1.0 - losses.dice_coeff(softmax(logits.reshape(-1, c)), onehot, (y != 255) * 1.0)

    return {
        'tversky': lambda lg, lb: losses.tversky_loss_with_logits(lg, lb, alpha=0.7, beta=0.3,
                                                                  gamma=0.75),
        'ohem': lambda lg, lb: losses.online_hard_example_mining(
            losses.softmax_ce_loss_with_logits(lg, lb, reduction='none'), keep_ratio=0.25),
        'ls ce': lambda lg, lb: losses.label_smoothing_cross_entropy(lg, lb, eps=0.1,
                                                                     ignore_index=255),
        'ls bce': lambda lg, lb: losses.label_smoothing_binary_cross_entropy(
            lg[..., 0], (lb > 0) * 1.0 + (lb == 255) * 254.0),
        'focal norm': lambda lg, lb: losses.focal_loss(lg[..., 1], (lb == 1) * 1.0,
                                                       normalize=True),
        'dice_coeff': dice_coeff,
    }


_torch_ops = (lambda a: torch.softmax(a, -1), torch.arange)
_jax_ops = (lambda a: jax.nn.softmax(a, -1), jnp.arange)
# the same float32 arithmetic a gradient element at a time in one process
# and over the ranks: held to 1e-12
EXACT_GRADIENTS = ('ce', 'bce', 'ohem', 'ls ce', 'ls bce')


def _jax_value_and_grad(name, logits, labels):
    fn = {'ce': jloss.softmax_ce_loss_with_logits, 'bce': _bce(jloss),
          'dice': jloss.dice_loss_with_logits, 'dice axis': jloss.dice_loss_with_logits,
          **_more_losses(jloss, _jax_ops)}[name]
    with jax.enable_x64(True):
        value, grad = jax.value_and_grad(lambda lg: fn(lg, jnp.asarray(labels)))(
            jnp.asarray(logits))
        return float(value), np.asarray(grad)


@pytest.mark.parametrize('name', ['ce', 'dice', 'dice axis', 'bce', 'tversky', 'ohem',
                                  'ls ce', 'ls bce', 'focal norm', 'dice_coeff'])
def test_losses_are_global_with_uneven_ignored_pixels(ranks, name):
    """Rank 0 ignores most of its pixels and rank 1 few.  Both ranks get
    the loss one process computes on the whole batch, and each rank's
    logits get ``WORLD`` times their share of its gradient (the all-reduce's
    gradient sums the ranks', and DDP's average over the ranks divides it
    out); the JAX function on the global batch gives the same value and
    gradient.  Both packages compute these losses in float32 (the logits are
    cast), so the values agree to rtol 1e-6 (float32 sums in another order).
    The cross-entropy's and the BCE's gradient elements are the same float32
    arithmetic in the port's one-process and two-rank runs (1e-12); the BCE
    sums Σloss and Σvalid with one all-reduce; the dice gradient goes
    through the float32 class sums, added in another order (1e-6 of its
    largest element); JAX's softmax rounds differently (1e-6).  Of the
    rest, OHEM's top k over the gathered per-pixel losses and both
    label-smoothing losses' sums (one all-reduce each) are exact a gradient
    element at a time like the CE; the Tversky, ``dice_coeff`` and the
    normalised focal loss (ΣBCE / Σmodulated) go through class or batch
    sums added in another order, held as the dice."""
    logits, labels = _loss_inputs()
    fn = {'ce': tloss.softmax_ce_loss_with_logits, 'bce': _bce(tloss),
          'dice': tloss.dice_loss_with_logits, 'dice axis': tloss.dice_loss_with_logits,
          **_more_losses(tloss, _torch_ops)}[name]
    lt = torch.from_numpy(logits).requires_grad_()
    value = fn(lt, torch.from_numpy(labels))
    value.backward()
    value = value.detach()
    grad_atol = 0.0 if name in EXACT_GRADIENTS else 1e-6 * float(lt.grad.abs().max())
    jvalue, jgrad = _jax_value_and_grad(name, logits, labels)
    np.testing.assert_allclose(float(value), jvalue, rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), jgrad, rtol=1e-6, atol=1e-9)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res[name]['value']), float(value), rtol=1e-6)
        np.testing.assert_allclose(res[name]['grad'].numpy() / WORLD,
                                   _rank_slice(lt.grad.numpy(), r, WORLD), rtol=1e-12,
                                   atol=grad_atol)
    assert float(ranks[0][name]['value']) == float(ranks[1][name]['value'])


def test_a_plain_average_of_the_ranks_means_is_not_the_global_loss():
    """What DDP alone would give: each rank's own mean cross-entropy,
    averaged over the ranks, misses the global mean (the ranks' valid
    counts differ) by far more than the tolerance the test above holds the
    port to, in value and in gradient."""
    logits, labels = _loss_inputs()
    lt = torch.from_numpy(logits).requires_grad_()
    parts = [tloss.softmax_ce_loss_with_logits(_rank_slice(lt, r, WORLD),
                                               torch.from_numpy(_rank_slice(labels, r, WORLD)))
             for r in range(WORLD)]
    plain = sum(parts) / WORLD
    plain.backward()
    jvalue, jgrad = _jax_value_and_grad('ce', logits, labels)
    assert abs(float(plain) - jvalue) > 1e-3 * abs(jvalue)
    assert np.abs(lt.grad.numpy() - jgrad).max() > 1e-3 * np.abs(jgrad).max()


def test_axis_name_outside_a_mesh_raises():
    logits, labels = _loss_inputs()
    with pytest.raises(ValueError, match='outside a mesh'):
        tloss.dice_loss_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                    axis_name='data')


# -- drop-path ------------------------------------------------------------------------

def test_drop_path_draws_are_the_global_batchs(ranks):
    """Each rank's masks are its slice of the masks one process draws for
    the global batch of 6 from the same generator, and the generator moves
    on identically on every rank."""
    gen = torch.Generator().manual_seed(3)
    want = [drop_path_mask(3 * WORLD, 0.4, gen) for _ in range(2)]
    after = torch.rand(2, generator=gen)
    for r, res in enumerate(ranks):
        for got, w in zip(res['drop'], want):
            assert torch.equal(got, _rank_slice(w, r, WORLD))
        assert torch.equal(res['drop_after'], after)
    assert not torch.equal(want[1][:3], want[1][3:])          # the slices differ


# -- tiled inference ------------------------------------------------------------------

@pytest.mark.parametrize('i', range(len(TILED)))
def test_tiled_inference_over_a_mesh(ranks, i):
    """The tile list split over the two ranks (each padded to whole batches
    with weight-0 repeats), one all-reduce of canvas and counts: both ranks
    return the scene one process computes, and (without TTA) the JAX
    package's ``tiled_inference(mesh=)`` on a 2-device CPU mesh; 1e-5, as
    ``test_torch_tiled.py``."""
    case = TILED[i]
    image = _scene(case['h'], case['w'])
    want = torch_tiled(torch_predict, image, case['k'], case['stride'], K,
                       tile_batch=case['tile_batch'], tta=case['tta'], device='cpu').numpy()
    for res in ranks:
        np.testing.assert_allclose(res[f'tiled {i}'].numpy(), want, rtol=1e-5, atol=1e-5)
    if case['tta'] is None:
        mesh = jax_make_mesh(('data',), devices=jax.devices()[:WORLD])
        jwant = np.asarray(jax_tiled(jax_predict, jnp.asarray(image), case['k'], case['stride'],
                                     K, tile_batch=case['tile_batch'], mesh=mesh))
        np.testing.assert_allclose(ranks[0][f'tiled {i}'].numpy(), jwant, rtol=1e-5, atol=1e-5)
