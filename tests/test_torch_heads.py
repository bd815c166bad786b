"""The four segmentation heads in the port against the JAX package, on the
CPU: ``ASPPHead`` (DeepLabv3), ``PPMHead`` (PSPNet), ``Deeplabv3pHead`` and
``HRNetHead``, at narrow widths in float64, in eval and train mode.  For
each: the logits, the running statistics after a train forward, and the
gradients of every parameter and every input feature for a seeded
cotangent against ``jax.vjp``.  Weights are seeded draws in the JAX tree
carried over by ``convert_flax_head``; inputs are seeded numpy draws.

Tolerance 1e-5 of the scale: every head ends in a bilinear resize that the
JAX package computes in float32 whatever the input, and the pools
(``global_avg_pool``, ``adaptive_avg_pool``) do too; both packages round
there (float32 rounding, 6e-8), in other summation orders, and a
parameter's gradient sums those rounded terms over up to 2·104² pixels;
in train mode the ASPP's image-pool BatchNorm normalises B = 2 pooled
values a channel, which divides their rounding by half their difference.
Everything else is float64.

The dropouts draw other masks in the two packages, so the comparisons run
with them off on both sides: ``ASPPHead`` through its config, the ASPP
inside ``Deeplabv3pDecoder`` (built without a rate, so at 0.5) by a
test-local subclass in the JAX package's ``heads`` namespace and the port
module's ``dropout_rate``.  The dropouts themselves are held on their own:
the keep share within binomial bounds, the 1/(1−p) scale, and the PPM's
whole-channel dropout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.module import heads as jheads
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import heads as theads
from ever_tpu_torch.util.weight_io import convert_flax_head, flatten_params
from test_torch_resnet import close, one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _nchw, _nhwc, _seeded, _x, jax_vjp

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TOL = 1e-5
CLASSES = 3
HEADS = {
    'aspp': ('ASPPHead', dict(aspp=dict(in_channels=16, out_channels=8, atrous_rates=[2, 4, 6],
                                        dropout_rate=0.0), upsample_scale=8.0),
             [(2, 6, 6, 16)]),
    'ppm': ('PPMHead', dict(ppm=dict(in_channels=16, pool_channels=4, out_channels=8,
                                     bins=(1, 2, 3, 6))), [(2, 13, 13, 16)]),
    'deeplabv3p': ('Deeplabv3pHead', dict(deeplabv3p_decoder=dict(
        os4_feature_channels=8, os16_feature_channels=16, aspp_channels=8,
        aspp_atrous=(2, 4, 6), reduction_dim=4, out_channels=8)),
        [(2, 16, 16, 8), (2, 4, 4, 16)]),
    'hrnet': ('HRNetHead', dict(hrnet_decoder=dict(in_channels=4 + 6 + 8 + 10)),
              [(2, 16, 16, 4), (2, 8, 8, 6), (2, 4, 4, 8), (2, 2, 2, 10)]),
}


class _NoDropASPP(jheads.AtrousSpatialPyramidPool):
    """The JAX ASPP with its dropout off (``Deeplabv3pDecoder`` builds it
    with the class default)."""
    dropout_rate: float = 0.0


@pytest.fixture
def no_decoder_dropout(monkeypatch):
    monkeypatch.setattr(jheads, 'AtrousSpatialPyramidPool', _NoDropASPP)


def _inputs(shapes):
    xs = [_x(s, seed=i) for i, s in enumerate(shapes)]
    return xs if len(xs) > 1 else xs[0]


def _port_head(name, cfg, v):
    tm = tbuilder.make_model({'type': name, 'params': cfg}, device='cpu').double()
    tm.load_state_dict(convert_flax_head(v), strict=True)
    for m in tm.modules():
        if isinstance(m, theads.AtrousSpatialPyramidPool):
            m.dropout_rate = 0.0
    return tm


@pytest.mark.usefixtures('no_decoder_dropout')
@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', sorted(HEADS))
def test_heads_match_jax(case, train):
    """Logits, running statistics and gradients in float64 (module
    docstring for the tolerance)."""
    name, cfg, shapes = HEADS[case]
    cfg = dict(cfg, num_classes=CLASSES, dtype='float64')
    xs = _inputs(shapes)
    as_list = isinstance(xs, list)
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': name, 'params': cfg})
        jx = [jnp.asarray(a) for a in xs] if as_list else jnp.asarray(xs)
        v = _seeded(jm, jx, train=train)

        def f(params, jx):
            return jm.apply({**v, 'params': params}, jx, train=train, mutable=['batch_stats'])

        want, (dparams, dx), mut, g = jax_vjp(f, v['params'], jx, has_aux=True)
    tm = _port_head(name, cfg, v)
    tx = [_nchw(a).requires_grad_() for a in xs] if as_list else _nchw(xs).requires_grad_()
    got = tm(tx, train=train)
    params = dict(tm.named_parameters())
    txs = tx if as_list else [tx]
    grads = torch.autograd.grad(got, list(params.values()) + txs, _nchw(g))
    assert tuple(_nhwc(got).shape) == want.shape
    close(_nhwc(got), want, TOL)
    jgrads = convert_flax_head(dparams)
    assert set(jgrads) == set(params)
    for (pname, _), d in zip(params.items(), grads):
        close(d.numpy(), jgrads[pname].numpy(), TOL)
    for d, w in zip(grads[len(params):], dx if as_list else [dx]):
        close(_nhwc(d), w, TOL)
    sd = tm.state_dict()
    moved = convert_flax_head({}, mut['batch_stats']) if train else {}
    assert train == bool(moved)
    for k, w in moved.items():
        close(sd[k].numpy(), w.numpy(), TOL)


@pytest.mark.parametrize('case', sorted(HEADS))
def test_converter_covers_every_variable(case):
    """Every JAX param and batch statistic of the head maps to one port
    key and the port has no key left without a value; a stray variable
    raises."""
    name, cfg, shapes = HEADS[case]
    cfg = dict(cfg, num_classes=CLASSES)
    xs = _inputs(shapes)
    jm = jbuilder.make_model({'type': name, 'params': cfg})
    jx = [jnp.asarray(a, jnp.float32) for a in xs] if isinstance(xs, list) \
        else jnp.asarray(xs, jnp.float32)
    v = _seeded(jm, jx)
    sd = convert_flax_head(v)
    tm = tbuilder.make_model({'type': name, 'params': cfg}, device='cpu')
    n_jax = len(flatten_params(v['params'])) + len(flatten_params(v['batch_stats']))
    assert len(sd) == n_jax and set(sd) == set(tm.state_dict())
    with pytest.raises(KeyError, match='unmapped'):
        convert_flax_head({'extra': {'kernel': np.zeros((1, 1, 1, 1))}})


def _aspp(rate):
    torch.manual_seed(0)
    return theads.AtrousSpatialPyramidPool(16, 8, (2, 4), dropout_rate=rate).double()


def test_aspp_dropout_keeps_within_binomial_bounds_and_scales():
    """ASPP's element dropout (0.5 by default, as in the JAX package): the
    kept share of 2·8·12·12 elements within 5 σ of ½, every kept element
    twice the undropped output exactly, the draw a function of the
    generator alone; a train forward without a generator raises."""
    assert theads.AtrousSpatialPyramidPool().dropout_rate == 0.5
    assert jheads.AtrousSpatialPyramidPool.__dataclass_fields__['dropout_rate'].default == 0.5
    x = _nchw(_x((2, 12, 12, 16)))
    ref = _aspp(0.0)(x, train=True)
    m = _aspp(0.5)
    gen = torch.Generator().manual_seed(3)
    got = m(x, train=True, generator=gen)
    again = _aspp(0.5)(x, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, again)
    nonzero = ref != 0
    kept = (got != 0) & nonzero
    n = int(nonzero.sum())
    share = float(kept.sum()) / n
    assert abs(share - 0.5) <= 5 * (0.25 / n) ** 0.5, share
    assert torch.equal(got[kept], 2 * ref[kept])
    assert bool((got[~kept] == 0).all())
    with pytest.raises(ValueError, match='generator'):
        m(x, train=True)
    plain = _aspp(0.0)
    plain.load_state_dict(m.state_dict())
    assert torch.equal(m(x), plain(x))             # no dropout in evaluation


def test_ppm_dropout_drops_whole_channels():
    """``PyramidPoolModule(dropout_rate=0.3)``: each sample's channel is
    either zero at every pixel or the undropped channel / 0.7 at every
    pixel (the reference's ``Dropout2d``), the kept share of the 2·8
    channel draws within bounds over 20 draws; ``dropout=`` (the
    reference's spelling) is the same rate."""
    x = _nchw(_x((2, 12, 12, 16)))

    def ppm(**kw):
        torch.manual_seed(0)
        return theads.PyramidPoolModule(16, 4, 8, (1, 2, 3, 6), **kw).double()

    ref = ppm()(x, train=True)
    assert ppm(dropout=0.3).rate == 0.3
    m = ppm(dropout_rate=0.3)
    gen = torch.Generator().manual_seed(1)
    kept_total = 0
    for _ in range(20):
        got = m(x, train=True, generator=gen)
        zero = (got == 0).all(dim=(2, 3))
        full = (got == ref / 0.7).all(dim=(2, 3))
        assert bool((zero ^ full).all())
        kept_total += int(full.sum())
    n = 20 * 2 * 8
    assert abs(kept_total / n - 0.7) <= 5 * (0.21 / n) ** 0.5


def test_heads_resolve_through_make_model():
    """The heads build through ``builder.make_model`` under the JAX names,
    with the JAX package's defaults (``HRNetHead`` 480 wide: HRNetV2-W32;
    ``Deeplabv3pHead`` on ResNet-50's 256 and 2048; ASPP and PPM on 2048,
    ×8)."""
    for name, want in (('ASPPHead', 2048), ('PPMHead', 2048), ('Deeplabv3pHead', 2048),
                       ('HRNetHead', 480)):
        m = tbuilder.make_model({'type': name, 'params': {}}, device='cpu')
        assert type(m).__name__ == name
        widths = {p.shape[1] for n, p in m.named_parameters() if p.dim() == 4}
        assert want in widths, (name, widths)
