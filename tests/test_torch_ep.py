"""The port's mixture-of-experts layer and expert parallel
(``ever_tpu_torch.parallel.ep``) against ``ever_tpu.parallel.ep``, on the
CPU.

In one process, with the JAX module's weights (``convert_flax_moe``):
``MoEMlp`` top-1 at full capacity (and the selected expert's MLP), the
dropped overflow, the Switch auxiliary loss, ``moe_expert_shardings``'
indivisible guard, and ``sown_aux_loss`` through ``build_train_step``
against the JAX step on the JAX test's model.  One job of two gloo ranks
(``torch_layout_ranks.ep_worker``, which imports no JAX) runs the JAX
test's expert-parallel layer (8 experts, k=2, capacity factor 2) split
over an ``'expert'`` axis of 2: the output, the auxiliary loss and every
gradient of ``sum(y²) + aux`` against one process of the port and against
the JAX module.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from ever_tpu.core import builder as jbuilder
from ever_tpu.parallel import ep as jep
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel.ep import MoEMlp, moe_expert_shardings
from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state, sown_losses
from ever_tpu_torch.util.weight_io import convert_flax_moe
from test_torch_dist import start_ranks
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

# float32 with the router in float32: the products and the gated sums add in
# another order than XLA's einsums
TOL = dict(rtol=1e-5, atol=1e-6)
# gradients against each tensor's largest element (the split's partial sums
# add in another order again)
GRAD_TOL = 1e-5
EP_KW = dict(num_experts=8, hidden=16, k=2, capacity_factor=2.0, dim=8)


def _port(jax_kw: dict, variables, dim: int) -> MoEMlp:
    moe = MoEMlp(**jax_kw, dim=dim, device='cpu')
    moe.load_state_dict(convert_flax_moe(variables['params']))
    return moe


def _variables(kw: dict, dim: int, seed: int = 0) -> dict:
    """Seeded weights in the JAX module's layout (its biases non-zero)."""
    rng = np.random.default_rng(seed)
    e, h = kw['num_experts'], kw['hidden']
    p = dict(router=0.5 * rng.normal(size=(dim, e)),
             experts_fc1=rng.normal(size=(e, dim, h)) / np.sqrt(dim),
             experts_bias1=0.1 * rng.normal(size=(e, h)),
             experts_fc2=rng.normal(size=(e, h, dim)) / np.sqrt(h),
             experts_bias2=0.1 * rng.normal(size=(e, dim)))
    return {'params': {k: v.astype(np.float32) for k, v in p.items()}}


def _jax(kw: dict, x):
    """The JAX module on ``_variables``: the variables, output and sown
    loss."""
    moe = jep.MoEMlp(**kw)
    variables = _variables(kw, x.shape[-1])
    y, mut = jax.jit(lambda v, a: moe.apply(v, a, mutable=['losses']))(variables, x)
    return moe, variables, np.asarray(y), float(jax.tree.leaves(mut['losses'])[0])


def test_moe_top1_full_capacity_equals_selected_expert():
    """k=1 with capacity for every token: each token's output is its argmax
    expert's MLP (tanh GELU), as the JAX test checks, and equals the JAX
    module's output."""
    kw = dict(num_experts=4, hidden=16, k=1, capacity_factor=4.0)
    x = np.random.default_rng(0).normal(size=(2, 6, 8)).astype(np.float32)
    _, variables, want, _ = _jax(kw, x)
    moe = _port(kw, variables, 8)
    y = moe(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y, want, **TOL)
    p = {k: v.detach().numpy() for k, v in moe.state_dict().items()}
    xt = x.reshape(-1, 8)
    choice = (xt @ p['router']).argmax(-1)
    h = np.stack([xt[i] @ p['experts_fc1'][c] + p['experts_bias1'][c]
                  for i, c in enumerate(choice)])
    h = torch.nn.functional.gelu(torch.from_numpy(h), approximate='tanh').numpy()
    ref = np.stack([h[i] @ p['experts_fc2'][c] + p['experts_bias2'][c]
                    for i, c in enumerate(choice)])
    np.testing.assert_allclose(y.reshape(-1, 8), ref, rtol=1e-4, atol=1e-5)


def test_moe_capacity_drops_overflow_tokens():
    """Identical tokens all route to one expert of capacity ceil(8·0.25/2)
    = 1: one token survives, the others contribute exactly zero, as in the
    JAX module."""
    kw = dict(num_experts=2, hidden=8, k=1, capacity_factor=0.25)
    x = np.ones((1, 8, 4), np.float32)
    _, variables, want, _ = _jax(kw, x)
    y = _port(kw, variables, 4)(torch.from_numpy(x)).detach().numpy()[0]
    assert (np.abs(y).sum(-1) > 1e-9).sum() == 1
    np.testing.assert_allclose(y, want[0], **TOL)


def test_moe_aux_loss_is_sown_as_jax():
    """The Switch load-balancing loss lands in the open ``sown_losses``
    collection under ``moe_aux_loss`` with the JAX module's value; outside
    a collection nothing is kept."""
    kw = dict(num_experts=4, hidden=16)
    x = np.ones((2, 8, 8), np.float32)
    _, variables, want_y, want_aux = _jax(kw, x)
    moe = _port(kw, variables, 8)
    with sown_losses() as sown:
        y = moe(torch.from_numpy(x))
    assert list(sown) == ['moe_aux_loss'] and len(sown['moe_aux_loss']) == 1
    aux = sown['moe_aux_loss'][0].item()
    assert np.isfinite(aux) and aux > 0
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    moe(torch.from_numpy(x))                    # no collection open: dropped


def test_moe_expert_shardings_indivisible_replicates():
    """6 experts over 4 ranks: every leaf replicated (the JAX fallback); 8
    experts: the ``experts_*`` leaves split on their expert dimension, the
    router replicated."""
    mesh = tmesh.abstract_mesh(4, ('expert',))
    six = moe_expert_shardings(MoEMlp(6, 16, dim=8, device='cpu').state_dict(), mesh)
    assert all(s.spec == () for s in six.values()) and len(six) == 5
    eight = moe_expert_shardings(MoEMlp(8, 16, dim=8, device='cpu').state_dict(), mesh)
    assert {n: tuple(s.spec) for n, s in eight.items()} == {
        'router': (), 'experts_fc1': ('expert',), 'experts_bias1': ('expert',),
        'experts_fc2': ('expert',), 'experts_bias2': ('expert',)}
    with pytest.raises(ValueError, match='abstract mesh'):
        MoEMlp(8, 16, dim=8, device='cpu').shard_experts(mesh)


def _ep_input():
    return np.random.default_rng(1).normal(size=(4, 8, 8)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_ep():
    """The JAX test's layer and input; on one device its output, auxiliary
    loss and the gradients of ``sum(y²) + aux``."""
    kw = {k: v for k, v in EP_KW.items() if k != 'dim'}
    x = _ep_input()
    moe, variables, y, aux = _jax(kw, x)

    def loss(p, xx):
        out, mut = moe.apply({'params': p}, xx, mutable=['losses'])
        return jnp.sum(out ** 2) + jax.tree.leaves(mut['losses'])[0]

    g, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables['params'], x)
    return x, variables, y, aux, convert_flax_moe(g), np.asarray(gx)


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory):
    """The expert-parallel job's two ranks, started before the module's
    first test; killed at the end if still running."""
    tmp = tmp_path_factory.mktemp('ep')
    torch.save(dict(kwargs=EP_KW, x=_ep_input(), state_dict=convert_flax_moe(
        _variables(EP_KW, 8)['params'])), tmp / 'ep-inputs.pt')
    ranks = start_ranks('torch_layout_ranks', 'ep_worker', 2, tmp, tmp)
    yield tmp, ranks
    ranks.kill()


@pytest.fixture(scope='module')
def ranks(job):
    tmp, started = job
    _jax_ep()                                   # while the ranks run
    started.finish(timeout=120)
    return [torch.load(tmp / f'ep-rank{r}.pt', weights_only=False) for r in range(2)]


def _one_process():
    """The port's layer whole in this process: output, aux, gradients."""
    x, variables, *_ = _jax_ep()
    moe = _port({k: v for k, v in EP_KW.items() if k != 'dim'}, variables, 8)
    xt = torch.from_numpy(x).requires_grad_()
    with sown_losses() as sown:
        y = moe(xt)
    aux = sown['moe_aux_loss'][0]
    ((y ** 2).sum() + aux).backward()
    return y.detach(), aux.item(), xt.grad, {n: p.grad for n, p in moe.named_parameters()}


def _close(got, want, scale_of):
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(scale_of).max())


def test_expert_parallel_matches_one_process_and_jax(ranks):
    """Each rank holds 4 of the 8 experts (rank r experts [4r, 4r + 4));
    both ranks' output and auxiliary loss, the input's and the router's
    gradients (partial sums through each rank's experts, summed; the aux
    loss's counted once) and each rank's experts' gradients, against one
    process of the port and against the JAX module."""
    y1, aux1, gx1, g1 = _one_process()
    _, _, y, aux, g, gx = _jax_ep()
    for r, res in enumerate(ranks):
        assert res['first'] == 4 * r
        assert res['shapes']['experts_fc1'] == (4, 8, 16) and res['shapes']['router'] == (8, 8)
        for want_y, want_aux in ((y1.numpy(), aux1), (y, aux)):
            np.testing.assert_allclose(res['y'].numpy(), want_y, **TOL)
            np.testing.assert_allclose(res['aux'], want_aux, rtol=1e-6)
        for want_gx, want_g in ((gx1.numpy(), g1), (gx, g)):
            _close(res['x_grad'].numpy(), want_gx, want_gx)
            for name, got in res['grads'].items():
                want = want_g[name].numpy()
                if name.startswith('experts_'):
                    want = want[4 * r:4 * r + 4]
                _close(got.numpy(), want, want)


def test_local_state_of_an_expert_parallel_state_raises_jax_s_error(ranks):
    """A state whose experts are split over the ranks has no whole copy on
    either: ``Launcher.local_state()`` (what a multi-process evaluation
    reads, C.5) raises the JAX launcher's error for a state split over the
    processes, with its message."""
    from test_torch_zero import jax_local_state_error
    for res in ranks:
        assert res['local_state'] == jax_local_state_error()


class _TorchTiny(nn.Module):
    """The JAX test's ``Tiny``: a ``MoEMlp`` and an MSE loss."""

    def __init__(self):
        super().__init__()
        self.MoEMlp_0 = MoEMlp(4, 8, dim=8, device='cpu')

    def forward(self, x, y=None, train=False, generator=None):
        h = self.MoEMlp_0(x)
        return dict(mse_loss=((h - 0.1) ** 2).mean()) if train else h


def test_sown_aux_loss_flows_into_train_step():
    """The JAX test's model through ``build_train_step``: the metrics hold
    ``sown_aux_loss``, ``total_loss`` is the MSE plus it, each equal to the
    JAX step's; the parameters after one SGD step equal JAX's."""
    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, y=None, train=False):
            h = jep.MoEMlp(num_experts=4, hidden=8)(x)
            return dict(mse_loss=jnp.mean((h - 0.1) ** 2)) if train else h

    x = np.random.default_rng(2).normal(size=(2, 8, 8)).astype(np.float32)
    jm = Tiny()
    jfactory, _ = jbuilder.make_optimizer(dict(type='sgd', params=dict(momentum=0.0)))
    jtx = jfactory.build(0.01)
    state = jax.jit(lambda: jspmd.create_train_state(jm, jtx, (x,)))()
    new, want = jspmd.build_train_step(jm, jtx, None, donate=False)(state, (x,))

    model = _TorchTiny()
    model.load_state_dict(convert_flax_moe(jax.device_get(state.params)))
    factory, _ = tbuilder.make_optimizer(dict(type='sgd', params=dict(momentum=0.0)))
    tx = factory.build(0.01)
    tstate, got = build_train_step(model, tx)(create_train_state(model, tx), (x,))
    assert set(got) >= {'sown_aux_loss', 'mse_loss', 'total_loss'}
    for k in ('sown_aux_loss', 'mse_loss', 'total_loss'):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got['total_loss']) > float(got['mse_loss'])
    for k, v in convert_flax_moe(jax.device_get(new.params)).items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
