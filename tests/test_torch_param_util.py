"""``util/param_util``, frozen parameters and param groups against the JAX
package, on the CPU.

The masks (``freeze_mask`` and its variants), the counts and
``frozen_param_prefixes`` at ``freeze_at`` 0 to 5 name the same parameters
in both packages: each JAX leaf is filled with its own index and carried to
the port's names by ``convert_flax_resnet`` / ``convert_flax_farseg``.  Then
three SGD-momentum and three AdamW steps with ``frozen_prefixes`` and with
``param_groups``: frozen parameters keep their bits, the others agree with
optax to ``test_torch_train.py``'s tolerance (rtol 1e-5, atol 1e-7), and
the recorded norm with optax's.  Last, the trainer's hooks: a FarSeg
config's ``encoder.freeze_at`` reaches the update rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.module import resnet as jres
from ever_tpu.opt import learning_rate as jlr
from ever_tpu.opt import optimizer as jopt
from ever_tpu.util import param_util as jpu
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import resnet as tres
from ever_tpu_torch.opt import learning_rate as tlr
from ever_tpu_torch.trainer import get_trainer as tget_trainer
from ever_tpu_torch.util import param_util as tpu
from ever_tpu_torch.util.weight_io import convert_flax_farseg, convert_flax_resnet

FARSEG = dict(encoder=dict(resnet_type='resnet18'), classes=5, dtype='float32',
              head=dict(fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=32),
                        fs_relation=dict(scene_embedding_channels=512,
                                         in_channels_list=(32,) * 4, out_channels=32),
                        fpn_decoder=dict(in_channels=32, out_channels=32)))


def _indexed(model, x_shape):
    """JAX variables whose every params leaf is filled with its index (and
    batch_stats with -1), and the leaves' '/'-paths in order."""
    shapes = jax.eval_shape(lambda: model.init({'params': jax.random.key(0)},
                                               jnp.zeros(x_shape, jnp.float32)))
    leaves, treedef = jax.tree_util.tree_flatten(shapes['params'])
    params = jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])
    stats = jax.tree.map(lambda s: np.full(s.shape, -1, np.float32), shapes['batch_stats'])
    return params, stats, jpu.param_paths(params)


def _port_name_of(sd):
    """{leaf index: port parameter name} from a converted indexed tree."""
    return {int(t.flatten()[0]): k for k, t in sd.items() if float(t.flatten()[0]) >= 0}


@pytest.fixture(scope='module')
def resnet18():
    cfg = dict(resnet_type='resnet18')
    params, stats, paths = _indexed(jres.ResNetEncoder(cfg), (1, 64, 64, 3))
    names = _port_name_of(convert_flax_resnet(params, stats))
    model = tres.ResNetEncoder(cfg)
    return params, paths, names, model


def _frozen_names(jmask, paths, names):
    flags = jax.tree.leaves(jmask)
    return {names[i] for i, (p, f) in enumerate(zip(paths, flags)) if not f}


def test_every_jax_leaf_has_one_port_parameter(resnet18):
    params, paths, names, model = resnet18
    assert sorted(names.values()) == sorted(tpu.param_paths(model))
    assert len(names) == len(paths)


@pytest.mark.parametrize('freeze_at', range(6))
def test_freeze_at_prefixes_name_the_same_parameters(resnet18, freeze_at):
    params, paths, names, _ = resnet18
    cfg = dict(resnet_type='resnet18', freeze_at=freeze_at)
    jprefixes = jres.ResNetEncoder(cfg).frozen_param_prefixes()
    model = tres.ResNetEncoder(cfg)
    tprefixes = model.frozen_param_prefixes()
    want = _frozen_names(jpu.freeze_mask(params, jprefixes), paths, names)
    mask = tpu.freeze_mask(model, tprefixes)
    got = {k for k, v in mask.items() if not v}
    assert got == want
    assert bool(got) == (freeze_at > 0)
    assert tpu.trainable_parameters(model, mask) == jpu.trainable_parameters(
        params, jpu.freeze_mask(params, jprefixes))


@pytest.mark.parametrize('which', ['bn', 'modules', 'params'])
def test_freeze_masks_and_counts_equal_jax(resnet18, which):
    params, paths, names, model = resnet18
    jmask, tmask = {
        'bn': (jpu.freeze_bn(params), tpu.freeze_bn(model)),
        'modules': (jpu.freeze_modules(params, 'layer2'), tpu.freeze_modules(model, 'layer2')),
        'params': (jpu.freeze_params(params, 'resnet/layer3'),
                   tpu.freeze_params(model, 'resnet.layer3')),
    }[which]
    assert {k for k, v in tmask.items() if not v} == _frozen_names(jmask, paths, names)
    assert tpu.count_model_parameters(model) == jpu.count_model_parameters(params)
    assert tpu.trainable_parameters(model, tmask) == jpu.trainable_parameters(params, jmask)


def test_farseg_encoder_freeze_reaches_the_update_rule(tmp_path):
    """``encoder.freeze_at`` 2 in a FarSeg config: the JAX trainer's
    ``encoder/`` prefixes and the port trainer's rule freeze the same
    parameters (the stem and layer1)."""
    jm = jbuilder.make_model({'type': 'FarSeg', 'params': FARSEG})
    params, stats, paths = _indexed(jm, (1, 64, 64, 3))
    names = _port_name_of(convert_flax_farseg(params, stats))
    jprefixes = tuple('encoder/' + p for p in jres.ResNetEncoder(
        dict(resnet_type='resnet18', freeze_at=2)).frozen_param_prefixes())
    want = _frozen_names(jpu.freeze_mask(params, jprefixes), paths, names)
    cfg = tmp_path / 'cfg.py'
    cfg.write_text(f"""
config = dict(
    model=dict(type='FarSeg', params={FARSEG!r}),
    learning_rate=dict(type='poly', params=dict(base_lr=0.01, power=0.9, max_iters=10)),
    optimizer=dict(type='sgd', params=dict(momentum=0.9, weight_decay=1e-4)),
    train=dict(num_iters=1),
)
""")
    trainer = tget_trainer('th_ddp', argv=['--config_path', str(cfg), '--model_dir',
                                           str(tmp_path / 'run'), '--device', 'cpu',
                                           'model.params.encoder.freeze_at', '2'])()
    model = trainer.make_model()
    _, rule = trainer.make_lr_optimizer(model)
    got = {n for n, _ in model.named_parameters() if rule.frozen(n)}
    assert got == want and any(n.startswith('encoder.resnet.layer1.') for n in got)
    opt = rule.init(model.named_parameters())
    kept = {id(p) for g in opt.param_groups for p in g['params']}
    assert all((id(p) in kept) != (n in want) for n, p in model.named_parameters())


# -- the optimizer with frozen parameters and groups ---------------------------------

def _tree(seed):
    """Parameters and three steps' gradients.  Each gradient is a shared
    direction plus smaller noise, as consecutive steps' are: a first moment
    that cancels to rounding level would make AdamW's m/sqrt(v) differ, in
    float32 sums of another order, by more than the tolerance below."""
    rng = np.random.default_rng(seed)
    params = {'stem': {'w': rng.normal(size=(4, 3)).astype(np.float32)},
              'layer1': {'a': rng.normal(size=(5,)).astype(np.float32),
                         'b': rng.normal(size=(2, 3)).astype(np.float32)},
              'head': {'w': rng.normal(size=(3, 3)).astype(np.float32),
                       'b': rng.normal(size=(3,)).astype(np.float32)}}
    base = jax.tree.map(lambda v: rng.normal(scale=0.3, size=v.shape), params)
    grads = [jax.tree.map(lambda b: (b + rng.normal(scale=0.1, size=b.shape)).astype(
        np.float32), base) for _ in range(3)]
    return params, grads


def _flat(tree):
    return {f'{a}.{b}': v for a, sub in tree.items() for b, v in sub.items()}


@pytest.mark.parametrize('name,opt_params', [('sgd', dict(momentum=0.9, weight_decay=1e-3)),
                                             ('adamw', dict(weight_decay=0.05))])
@pytest.mark.parametrize('mode', ['frozen', 'groups', 'both'])
@pytest.mark.parametrize('clip', [None, 0.5])
def test_frozen_and_grouped_steps_match_optax(name, opt_params, mode, clip):
    p0, grads = _tree(3)
    # optax's float32 Adam step on XLA's CPU is off a float64 evaluation by
    # about 7e-6 of the learning rate (the port's step matches float64 here):
    # base_lr 0.01 keeps that under the tolerance for parameters near 0.05
    jsched = jlr.CosineAnnealingLearningRate(base_lr=0.01, max_iters=10)
    tsched = tlr.CosineAnnealingLearningRate(base_lr=0.01, max_iters=10)
    grad_clip = None if clip is None else dict(max_norm=clip)
    frozen = ('stem', 'layer1/a') if mode in ('frozen', 'both') else None
    tfrozen = ('stem', 'layer1.a') if frozen else None
    groups = jgroups = None
    if mode in ('groups', 'both'):
        mults = {'slow': 0.1, 'fast': 1.0}
        jgroups = ({'stem': 'slow', 'layer1': 'slow', 'head': 'fast'}, mults)
        groups = ({'stem': 'slow', 'layer1': 'slow', 'head': 'fast'}, mults)
    jfactory, _ = jbuilder.make_optimizer({'type': name, 'params': opt_params})
    tx = jfactory.build(jsched, grad_clip=grad_clip, param_groups=jgroups,
                        frozen_prefixes=frozen)
    tfactory, _ = tbuilder.make_optimizer({'type': name, 'params': opt_params})
    rule = tfactory.build(tsched, grad_clip=grad_clip, param_groups=groups,
                          frozen_prefixes=tfrozen)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in _flat(p0).items()}
    opt = rule.init(tp.items())
    for step, g in enumerate(grads):
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in _flat(g).items():
            tp[k].grad = torch.from_numpy(v.copy())
        norm = rule.apply(opt, step)
        np.testing.assert_allclose(float(norm), float(jopt.find_recorded_grad_norm(state)),
                                   rtol=1e-6)
    want = _flat(jax.tree.map(np.asarray, jp))
    for k, v in want.items():
        got = tp[k].detach().numpy()
        if tfrozen and k.startswith(tfrozen):
            np.testing.assert_array_equal(got, _flat(p0)[k], err_msg=k)
            np.testing.assert_array_equal(v, _flat(p0)[k], err_msg=k)
        else:
            assert not np.array_equal(got, _flat(p0)[k]), k
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-7, err_msg=f'{name} {k}')


def test_apply_freeze_and_labels():
    factory, _ = tbuilder.make_optimizer({'type': 'adamw', 'params': {}})
    model = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.Linear(3, 2))
    rule = tpu.apply_freeze(factory.build(0.1), tpu.freeze_params(model, '0.'))
    opt = rule.init(model.named_parameters())
    assert [p.shape for p in opt.param_groups[0]['params']] == [(2, 3), (2,)]
    rule = factory.build(0.1, param_groups=({'': 'all', '1': 'last'}, {'all': 1.0, 'last': 0.5}))
    opt = rule.init(model.named_parameters())
    assert [g['lr_mult'] for g in opt.param_groups] == [1.0, 0.5]
    assert [len(g['params']) for g in opt.param_groups] == [2, 2]
    rule.apply(opt, 0)      # no gradients: nothing moves, the rates are set
    assert [g['lr'] for g in opt.param_groups] == [pytest.approx(0.1), pytest.approx(0.05)]
    with pytest.raises(KeyError, match='no label'):
        factory.build(0.1, param_groups=({'1': 'last'}, {'last': 1.0})).init(
            model.named_parameters())


def test_count_model_flops_counts_a_matmul():
    lin = torch.nn.Linear(64, 32, bias=False)
    assert tpu.count_model_flops(lin, torch.zeros(8, 64)) == 2 * 8 * 64 * 32
