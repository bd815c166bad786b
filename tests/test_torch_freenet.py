"""FreeNet and SpectralAttention in the port against the JAX package, on the CPU.

A narrow FreeNet (stages (8, 8, 16, 16), 16 bands, 5 classes) on one odd
37×29 scene: the 2×2 ``'VALID'`` pools floor it to 18×14, 9×7 and 4×3,
and the decoder upsamples 4×3 → 9×7 → 18×14 → 37×29, ratios that are not
whole numbers.  Labels are sparse, as hyperspectral ground truth is:
about 5 % of the pixels carry a class, the rest 255.  Both packages run
from the same seeded variables in float64 (``jax.enable_x64``), the JAX
side under ``jax.jit``: the training loss and the gradient of every
parameter, and the eval probabilities.

Tolerance: 1e-5 of the scale.  Both packages compute the spectral gates'
global pools, the decoder's bilinear resizes and the logits in float32
whatever the input (``ever_tpu/module/ops.py`` ``global_avg_pool``,
``resize``, and the model's own cast), so float64 parity holds to float32
rounding in other summation orders: the loss (1.84) measured 1.2e-7
apart, the gradients 1.6e-7 of their scale and the probabilities 1.8e-7.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import registry as jregistry
from ever_tpu.module import freenet as jfree
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.module import freenet as tfree
from ever_tpu_torch.util.weight_io import convert_flax_freenet, load_weights
from ever_tpu.util.weight_io import flatten_tree
from test_torch_resnet import close, one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _seeded

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TOL = 1e-5
CFG = dict(in_channels=16, stage_channels=(8, 8, 16, 16), classes=5, dtype='float64')
H, W, BANDS = 37, 29, 16


def _scene(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, H, W, BANDS))
    y = np.full((1, H, W), 255, np.int32)
    labelled = rng.random((1, H, W)) < 0.05
    y[labelled] = rng.integers(0, CFG['classes'], labelled.sum())
    return x, y


@pytest.fixture(scope='module')
def jax_reference():
    """The JAX FreeNet's seeded variables, its loss and parameter gradients
    on the sparse labels, and its eval probabilities, in float64."""
    x, y = _scene()
    with jax.enable_x64(True):
        jm = jfree.FreeNet(CFG)
        v = _seeded(jm, jnp.asarray(x))

        def loss(params):
            return jm.apply({'params': params}, jnp.asarray(x), jnp.asarray(y),
                            train=True)['cls_loss']

        value, grads = jax.jit(jax.value_and_grad(loss))(v['params'])
        probs = jax.jit(lambda p: jm.apply({'params': p}, jnp.asarray(x)))(v['params'])
    return dict(x=x, y=y, v=v, loss=float(value), grads=grads, probs=np.asarray(probs))


def _port(v):
    tm = tfree.FreeNet(CFG).double()
    tm.load_state_dict(convert_flax_freenet(v), strict=True)
    return tm


def test_loss_and_gradients_match_jax(jax_reference):
    """The cross-entropy over the labelled pixels alone (against one
    computed by hand from the logits) and every parameter's gradient."""
    r = jax_reference
    tm = _port(r['v'])
    out = tm(torch.from_numpy(r['x']), torch.from_numpy(r['y']).long(), train=True)
    assert set(out) == {'cls_loss'} and out['cls_loss'].dtype == torch.float32
    out['cls_loss'].backward()
    close(out['cls_loss'].item(), r['loss'], TOL)
    want = convert_flax_freenet(r['grads'])
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for k, p in named.items():
        close(p.grad.numpy(), want[k].numpy(), TOL)
    # the loss is the mean cross-entropy over the labelled pixels alone
    seen = []
    hook = tm.classifier.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        tm(torch.from_numpy(r['x']))
    hook.remove()
    logp = torch.log_softmax(seen[0].permute(0, 2, 3, 1).float(), -1)
    y = torch.from_numpy(r['y']).long()
    keep = y != 255
    manual = -logp[keep].gather(1, y[keep][:, None]).mean()
    close(out['cls_loss'].item(), manual.item(), 1e-6)


def test_eval_probabilities_match_jax(jax_reference):
    r = jax_reference
    with torch.no_grad():
        got = _port(r['v'])(torch.from_numpy(r['x'])).numpy()
    assert got.shape == (1, H, W, CFG['classes']) and got.dtype == np.float32
    close(got, r['probs'], TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_pools_floor_and_the_decoder_returns_to_the_scene():
    """The laterals' sizes are the floored pools' (37×29 → 18×14 → 9×7 →
    4×3) and every decoder level grows to the next lateral's exact size."""
    tm = tfree.FreeNet(dict(CFG, dtype='float32'))
    sizes = []
    hooks = [getattr(tm, f'enc{i}').register_forward_hook(
        lambda m, i, o: sizes.append(tuple(o.shape[2:]))) for i in range(4)]
    with torch.no_grad():
        out = tm(torch.zeros(1, H, W, BANDS))
    for h in hooks:
        h.remove()
    assert sizes == [(37, 29), (18, 14), (9, 7), (4, 3)]
    assert out.shape == (1, H, W, CFG['classes'])


def test_spectral_attention_matches_jax_and_is_registered():
    """The gate alone on NCHW (the JAX one on NHWC), float64, with the
    bottleneck's floor of 4 channels (12 // 4 = 3 → 4)."""
    x = np.random.default_rng(4).normal(size=(2, 5, 6, 12))
    with jax.enable_x64(True):
        jm = jfree.SpectralAttention()
        v = _seeded(jm, jnp.asarray(x))
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tregistry.OP['SpectralAttention'](12).double()
    assert tm.reduce.out_channels == 4
    sd = {f'{m}.{"weight" if leaf == "kernel" else leaf}':
          torch.from_numpy(np.transpose(a, (3, 2, 0, 1)) if leaf == 'kernel' else np.asarray(a))
          for m, d in v['params'].items() for leaf, a in d.items()}
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    close(got, want, TOL)
    assert set(jregistry.OP) >= {'SpectralAttention'}
    assert tregistry.MODEL['FreeNet'] is tfree.FreeNet


def test_npz_of_jax_variables_loads(jax_reference):
    """A flat ``.npz`` of the JAX FreeNet's variables through
    ``load_weights``: every tensor lands, equal to the converter's."""
    r = jax_reference
    flat = flatten_tree({'params': r['v']['params']})
    tm = tfree.FreeNet(CFG).double()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'freenet.npz')
        np.savez(path, **flat)
        report = load_weights(path, tm, device='cpu', log=False)
    assert not report.missing and not report.unexpected and not report.mismatched
    want = convert_flax_freenet(r['v'])
    for k, t in tm.state_dict().items():
        assert torch.equal(t, want[k].to(t.dtype)), k
