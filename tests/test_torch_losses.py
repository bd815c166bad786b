"""The rest of the loss family in the port against the JAX package, on the
CPU.

Each loss takes the same seeded numpy inputs in both packages (logits
``[2, 8, 8, C]`` in float32, labels with ignored pixels), and its value and
its gradient with respect to the logits (``jax.value_and_grad`` against
autograd) must agree within 1e-5 relative: each element within 1e-5 of the
largest magnitude of the JAX tensor, the float32 rounding of sums over 128
pixels.  A loss whose result is a vector is reduced to a scalar with the
same seeded weights on both sides.  All-ignored batches must give the
same (finite) value and the same gradient in both, zero where JAX's is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module import loss as JL
from ever_tpu_torch.module import loss as TL
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REL = 1e-5
C = 4


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= REL * scale or err == 0.0, f'{what}: {err:.3e} against scale {scale:.3e}'


def logits(seed=0, shape=(2, 8, 8, C), scale=2.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def labels(seed=1, ignored=0.2, shape=(2, 8, 8), classes=C):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=shape).astype(np.int32)
    y[rng.random(shape) < ignored] = 255
    return y


def value_and_grad_both(jfn, tfn, x, weights=None):
    """Value and gradient with respect to ``x`` of ``jfn(x)`` and
    ``tfn(x)`` (reduced by ``weights`` when the result is a vector)."""
    def reduce(out, w):
        return out if w is None else (out * w).sum()

    jout = jfn(jnp.asarray(x))
    jv, jg = jax.value_and_grad(
        lambda a: reduce(jfn(a), None if weights is None else jnp.asarray(weights)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tout = tfn(xt)
    tv = reduce(tout, None if weights is None else torch.as_tensor(weights))
    tv.backward()
    return (np.asarray(jout), np.asarray(jv), np.asarray(jg),
            tout.detach().numpy(), tv.detach().numpy(), xt.grad.numpy())


def check_both(jfn, tfn, x, weights=None, what=''):
    jout, jv, jg, tout, tv, tg = value_and_grad_both(jfn, tfn, x, weights)
    close(tout, jout, f'{what} output')
    close(tv, jv, f'{what} value')
    close(tg, jg, f'{what} gradient')
    assert np.isfinite(tv).all() and np.isfinite(tg).all(), what
    return tv, tg


@pytest.mark.parametrize('kw', [
    dict(alpha=0.7, beta=0.3, gamma=0.75),
    dict(alpha=0.5),
    dict(alpha=[0.3, 0.5, 0.7, 0.2], gamma=2.0, smooth_value=0.5),
    dict(alpha=[0.3, 0.5, 0.7, 0.2], reduction='none'),
    dict(alpha=0.7, beta=0.3, ignored=1.0),
    dict(alpha=0.6, channels=1),
], ids=['alpha-beta-gamma', 'beta-default', 'alpha-list', 'none', 'all-ignored', 'sigmoid'])
def test_tversky_matches_jax(kw):
    kw = dict(kw)
    ignored, channels = kw.pop('ignored', 0.2), kw.pop('channels', C)
    x = logits(shape=(2, 8, 8, channels))
    if channels == 1:
        y = (np.random.default_rng(2).random((2, 8, 8)) < 0.4).astype(np.float32)
        y[0, 0, :3] = 255
    else:
        y = labels(ignored=ignored)
    w = np.random.default_rng(5).normal(size=channels).astype(np.float32) \
        if kw.get('reduction') == 'none' else None
    check_both(lambda a: JL.tversky_loss_with_logits(a, jnp.asarray(y), **kw),
               lambda a: TL.tversky_loss_with_logits(a, torch.as_tensor(y), **kw),
               x, w, 'tversky')


def test_tversky_unknown_reduction_raises_in_both():
    x, y = logits(), labels()
    for fn, mod in ((JL.tversky_loss_with_logits, jnp.asarray),
                    (TL.tversky_loss_with_logits, torch.as_tensor)):
        with pytest.raises(ValueError, match='unknown reduction'):
            fn(mod(x), mod(y), alpha=0.5, reduction='sum')


def ce_none_jax(a, y):
    return JL.softmax_ce_loss_with_logits(a, jnp.asarray(y), reduction='none')


def ce_none_torch(a, y):
    return TL.softmax_ce_loss_with_logits(a, torch.as_tensor(y), reduction='none')


@pytest.mark.parametrize('keep_ratio', [0.25, 0.7])
def test_ohem_of_per_pixel_ce_matches_jax(keep_ratio):
    """OHEM over the CE's per-pixel losses (zeros at the ignored pixels)."""
    x, y = logits(), labels(ignored=0.4)
    check_both(lambda a: JL.online_hard_example_mining(ce_none_jax(a, y), keep_ratio),
               lambda a: TL.online_hard_example_mining(ce_none_torch(a, y), keep_ratio),
               x, what=f'ohem {keep_ratio}')


@pytest.mark.parametrize('keep_ratio', [0.3, 0.5, 0.9])
def test_ohem_with_ties_and_zeros_matches_jax(keep_ratio):
    """Quarter steps give ties across the k-th value, and zeros inside the
    top k that the mean leaves out: the gradient reaches the same tied
    elements (the first in element order) in both packages."""
    x = (np.random.default_rng(7).integers(0, 4, size=(4, 5, 3)) / 4.0).astype(np.float32)
    x[0, 0] = 0.0
    tv, tg = check_both(lambda a: JL.online_hard_example_mining(a, keep_ratio),
                        lambda a: TL.online_hard_example_mining(a, keep_ratio),
                        x, what=f'ohem ties {keep_ratio}')
    k = max(int(keep_ratio * x.size), 1)
    assert np.count_nonzero(tg) == min(k, np.count_nonzero(x))


def test_ohem_all_zero_and_bad_ratio():
    x = np.zeros((3, 4), np.float32)
    tv, tg = check_both(lambda a: JL.online_hard_example_mining(a, 0.5),
                        lambda a: TL.online_hard_example_mining(a, 0.5), x, what='zeros')
    assert tv == 0.0
    for ratio in (0.0, 1.0, 1.5):
        for fn, mod in ((JL.online_hard_example_mining, jnp.asarray),
                        (TL.online_hard_example_mining, torch.as_tensor)):
            with pytest.raises(ValueError, match='keep_ratio'):
                fn(mod(x), ratio)


def binary_targets(seed=3, shape=(2, 8, 8)):
    return (np.random.default_rng(seed).random(shape) < 0.35).astype(np.float32)


@pytest.mark.parametrize('kw', [dict(), dict(gamma=1.5), dict(normalize=True),
                                dict(gamma=0.5, normalize=True)],
                         ids=['plain', 'gamma', 'normalize', 'gamma-normalize'])
def test_focal_matches_jax(kw):
    x, t = logits(shape=(2, 8, 8)), binary_targets()
    tv, tg = check_both(lambda a: JL.focal_loss(a, jnp.asarray(t), **kw),
                        lambda a: TL.focal_loss(a, torch.as_tensor(t), **kw), x, what='focal')
    if kw.get('normalize'):
        # the scale is not detached (as in the JAX package): the value and
        # the gradient are those of the summed BCE
        xt = torch.tensor(x, requires_grad=True)
        bce = TL.binary_cross_entropy_with_logits(xt, torch.as_tensor(t), reduction='sum')
        bce.backward()
        close(tv, bce.detach().numpy(), 'normalised focal against ΣBCE')
        close(tg, xt.grad.numpy(), 'normalised focal gradient against ΣBCE')


@pytest.mark.parametrize('kw', [dict(), dict(alpha=0.25), dict(alpha=0.25, reduction='sum'),
                                dict(gamma=1, reduction='none')],
                         ids=['mean', 'alpha', 'sum', 'none'])
def test_sigmoid_focal_matches_jax(kw):
    x, t = logits(shape=(2, 8, 8)), binary_targets()
    w = np.random.default_rng(4).normal(size=t.shape).astype(np.float32) \
        if kw.get('reduction') == 'none' else None
    check_both(lambda a: JL.sigmoid_focal_loss(a, jnp.asarray(t), **kw),
               lambda a: TL.sigmoid_focal_loss(a, torch.as_tensor(t), **kw), x, w,
               'sigmoid focal')


@pytest.mark.parametrize('kw', [
    dict(), dict(eps=0.2, ignore_index=255), dict(ignore_index=255, reduction='sum'),
    dict(ignore_index=255, reduction='none'), dict(ignore_index=255, ignored=1.0),
], ids=['default-ignore', 'ignored', 'sum', 'none', 'all-ignored'])
def test_label_smoothing_ce_matches_jax(kw):
    """The default ``ignore_index`` is -1: labels with 255 are then class
    ids out of range, so the default case draws none."""
    kw = dict(kw)
    ignored = kw.pop('ignored', 0.2 if 'ignore_index' in kw else 0.0)
    x, y = logits(), labels(ignored=ignored)
    w = np.random.default_rng(6).normal(size=y.size).astype(np.float32) \
        if kw.get('reduction') == 'none' else None
    check_both(lambda a: JL.label_smoothing_cross_entropy(a, jnp.asarray(y), **kw),
               lambda a: TL.label_smoothing_cross_entropy(a, torch.as_tensor(y), **kw), x, w,
               'label smoothing CE')


@pytest.mark.parametrize('kw', [dict(), dict(eps=0.05, reduction='sum'), dict(reduction='none'),
                                dict(ignored=1.0)], ids=['mean', 'sum', 'none', 'all-ignored'])
def test_label_smoothing_bce_matches_jax(kw):
    kw = dict(kw)
    ignored = kw.pop('ignored', 0.2)
    x, t = logits(shape=(2, 8, 8)), binary_targets()
    t[np.random.default_rng(8).random(t.shape) < ignored] = 255
    w = np.random.default_rng(9).normal(size=t.size).astype(np.float32) \
        if kw.get('reduction') == 'none' else None
    check_both(lambda a: JL.label_smoothing_binary_cross_entropy(a, jnp.asarray(t), **kw),
               lambda a: TL.label_smoothing_binary_cross_entropy(a, torch.as_tensor(t), **kw),
               x, w, 'label smoothing BCE')


def test_soft_cross_entropy_matches_jax():
    x = logits()
    target = np.random.default_rng(10).random((2, 8, 8, C)).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    check_both(lambda a: JL.soft_cross_entropy(a, jnp.asarray(target)),
               lambda a: TL.soft_cross_entropy(a, torch.as_tensor(target)), x, what='soft CE')
    with pytest.raises(ValueError, match='N, H, W, C'):
        TL.soft_cross_entropy(torch.zeros(8, C), torch.zeros(8, C))


def test_select_matches_jax():
    x, y = logits(), labels()
    jsel = JL.select(jnp.asarray(x), jnp.asarray(y))
    tsel = TL.select(torch.as_tensor(x), torch.as_tensor(y))
    assert tsel[0].dtype == torch.float32 and tsel[2].dtype == torch.float32
    for got, want in zip(tsel, jsel):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('with_valid', [False, True])
def test_dice_coeff_matches_jax(with_valid):
    x, y = logits().reshape(-1, C), labels().reshape(-1)
    onehot = np.eye(C, dtype=np.float32)[np.where(y == 255, 0, y)]
    valid = (y != 255).astype(np.float32) if with_valid else None
    check_both(
        lambda a: JL.dice_coeff(jax.nn.softmax(a, -1), jnp.asarray(onehot),
                                None if valid is None else jnp.asarray(valid), smooth_value=0.5),
        lambda a: TL.dice_coeff(torch.softmax(a, -1), torch.as_tensor(onehot),
                                None if valid is None else torch.as_tensor(valid),
                                smooth_value=0.5),
        x, what='dice_coeff')


def test_every_loss_is_registered_under_the_jax_name():
    from ever_tpu.core import registry as jreg
    from ever_tpu_torch.core import registry as treg

    names = ('tversky', 'ohem', 'focal', 'sigmoid_focal', 'label_smoothing_ce',
             'label_smoothing_bce', 'soft_ce')
    for name in names:
        assert jreg.LOSS[name].__name__ == treg.LOSS[name].__name__
    assert set(JL.__all__) == set(TL.__all__)
