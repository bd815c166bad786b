"""``api/infer_tool`` and the user's workflow from files on disk, against the
JAX package, on the CPU.

``build_from_model_dir`` picks the JAX package's checkpoint in every case
(``model-best``, ``checkpoint_info.json``'s ``last``, the highest
``checkpoint-N``, none).  Then the slice as a whole: ``create`` a project,
write a LoveDA tree with the port's PNG writer, and train a narrow DinoSeg
(2 blocks, width 64, float32, 64² crops) from the project's own
``configs/dinoseg_vitl_loveda.py`` through the JAX package's ``get_trainer``
and the project's ``train.py`` (the port), both from the same weights (a
``.npz`` of the JAX parameters as ``GLOBAL.weight.path``).  The logged losses
agree to rtol 2e-5; ``build_from_model_dir`` and ``tiled_inference`` over
the validation scenes give equal confusion matrices; a run with
``train.iterator_type='prefetched'`` is bit-equal to the normal one.
"""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.api import infer_tool as jinfer
from ever_tpu.core import builder as jbuilder
from ever_tpu.core.logger import Logger as JLogger
from ever_tpu.magic.tiled import tiled_inference as jtiled
from ever_tpu.module import vit as jvit
from ever_tpu.trainer import get_trainer as jget_trainer
from ever_tpu.util.weight_io import flatten_tree
from ever_tpu_torch.api import infer_tool as tinfer
from ever_tpu_torch.core.logger import Logger as TLogger
from ever_tpu_torch.data._png import write_png
from ever_tpu_torch.magic.tiled import tiled_inference as ttiled
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.util._main import create_project

TINY = ('vit_tiny_test', (2, 64, 2, 4.0, 'mlp'))
CLASSES = 7


# -- the checkpoint a model dir gives ----------------------------------------------

@pytest.mark.parametrize('files,info,want', [
    (['model-best.ckpt', 'checkpoint-3.ckpt'], None, 'model-best.ckpt'),
    (['checkpoint-2.ckpt', 'checkpoint-5.ckpt'], 'checkpoint-2.ckpt', 'checkpoint-2.ckpt'),
    (['checkpoint-2.ckpt', 'checkpoint-10.ckpt', 'checkpoint-9.ckpt'], None,
     'checkpoint-10.ckpt'),
    (['checkpoint-4.ckpt'], 'checkpoint-7.ckpt', 'checkpoint-4.ckpt'),   # a stale index
    ([], None, None),
], ids=['best', 'info-last', 'highest', 'stale-info', 'none'])
def test_model_dir_checkpoint_choice_is_jax_s(tmp_path, monkeypatch, files, info, want):
    (tmp_path / 'config.pkl').write_bytes(b'')
    for name in files:
        (tmp_path / name).write_bytes(b'')
    if info:
        (tmp_path / 'checkpoint_info.json').write_text(json.dumps(
            {'last': {'step': 7, 'name': info}}))
    monkeypatch.setattr(jinfer, 'build_from_file', lambda cfg: 'model')
    monkeypatch.setattr(jinfer, '_load_variables', lambda path: (os.path.basename(path), 0))
    monkeypatch.setattr(jinfer, 'build_and_load_from_file',
                        lambda cfg, path: ('model', os.path.basename(path), 0))
    monkeypatch.setattr(tinfer, 'build_and_load_from_file',
                        lambda cfg, path, device: ('model', os.path.basename(path), 0))
    if want is None:
        with pytest.raises(FileNotFoundError, match='no checkpoints'):
            jinfer.build_from_model_dir(str(tmp_path))
        with pytest.raises(FileNotFoundError, match='no checkpoints'):
            tinfer.build_from_model_dir(str(tmp_path), device='cpu')
        return
    got = tinfer.build_from_model_dir(str(tmp_path), device='cpu')
    assert got[1:] == jinfer.build_from_model_dir(str(tmp_path))[1:]
    assert got[1] == want and (got[2] == 'best') == (want == 'model-best.ckpt')


def test_export_model_is_not_ported(tmp_path):
    """The name is from before ``export_model`` was ported: it now has the
    JAX signature plus ``device`` and builds the model (a missing config
    raises ``FileNotFoundError``, no longer ``NotImplementedError``); its
    programs are held against the JAX package in ``test_torch_export.py``."""
    import inspect
    assert list(inspect.signature(tinfer.export_model).parameters) == \
        list(inspect.signature(jinfer.export_model).parameters) + ['device']
    with pytest.raises(FileNotFoundError):
        tinfer.export_model(str(tmp_path / 'cfg.py'), 'ckpt', (1, 64, 64, 3),
                            str(tmp_path / 'out'), device='cpu')


# -- the slice as a whole ------------------------------------------------------------

def _loveda_tree(root):
    """2 domains x 4 train scenes and 2 x 1 val scenes, 80² RGB, written by
    the port with Paeth and Average rows; masks in the official encoding."""
    rng = np.random.default_rng(11)
    for split, n in (('Train', 4), ('Val', 1)):
        for dom in ('Urban', 'Rural'):
            d = root / split / dom
            os.makedirs(d / 'images_png')
            os.makedirs(d / 'masks_png')
            for i in range(n):
                write_png(str(d / 'images_png' / f'{i}.png'),
                          rng.integers(0, 256, (80, 80, 3), dtype=np.uint8), filter_type=4)
                write_png(str(d / 'masks_png' / f'{i}.png'),
                          rng.integers(0, 8, (80, 80), dtype=np.uint8), filter_type=3)
    return str(root)


def _weights_npz(path):
    """Seeded JAX parameters of the narrow DinoSeg, flat as the JAX package's
    .npz files hold them."""
    model = jbuilder.make_model({'type': 'DinoSeg', 'params': dict(
        backbone=dict(name=TINY[0]), classes=CLASSES, dtype='float32')})
    shapes = jax.eval_shape(lambda: model.init({'params': jax.random.key(0)},
                                               jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(5)

    def draw(p, s):
        if 'scale' in jax.tree_util.keystr(p):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(scale=0.05, size=s.shape).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(draw, shapes['params'])
    np.savez(path, **{f'params/{k}': v for k, v in flatten_tree(params).items()})
    return str(path)


def _opts(root, weights, model_dir, num_iters=4):
    return ['--model_dir', str(model_dir),
            'model.params.backbone.name', TINY[0], 'model.params.dtype', 'float32',
            'model.params.GLOBAL', repr(dict(weight=dict(path=weights))),
            'data.train.params.root', root, 'data.train.params.crop_size', '64',
            'data.train.params.num_workers', '0',
            'data.test.params.root', root, 'data.test.params.batch_size', '2',
            'learning_rate.params.max_iters', str(num_iters),
            'learning_rate.params.warmup.step', '2',
            'train.num_iters', str(num_iters), 'train.log_interval_step', '1',
            'train.save_ckpt_interval_epoch', '1000', 'train.eval_after_train', 'False']


@pytest.fixture(scope='module')
def workflow(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('workflow')
    proj = tmp / 'proj'
    create_project(str(proj))
    root = _loveda_tree(tmp / 'LoveDA')
    cfg = str(proj / 'configs' / 'dinoseg_vitl_loveda.py')
    logged = {'jax': {}, 'port': {}, 'prefetched': {}}
    current = []

    def recorder(log_cls):
        train_log = log_cls.train_log

        def record(self, step, num_iters, loss_dict, *args):
            logged[current[-1]][step] = dict(loss_dict)
            return train_log(self, step, num_iters, loss_dict, *args)
        return record

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_SPECS, *TINY)
        mp.setitem(tvit.VIT_SPECS, *TINY)
        mp.setattr(JLogger, 'train_log', recorder(JLogger))
        mp.setattr(TLogger, 'train_log', recorder(TLogger))
        weights = _weights_npz(tmp / 'init.npz')
        current.append('jax')
        jget_trainer('th_ddp', argv=['--config_path', cfg] + _opts(root, weights, tmp / 'jax'))(
            ).run()
        models = {}
        for name, extra in (('port', []), ('prefetched', ['train.iterator_type', 'prefetched'])):
            current.append(name)
            mp.setattr(sys, 'argv', ['train.py', '--config_path', cfg, '--device', 'cpu']
                       + _opts(root, weights, tmp / name) + extra)
            runpy.run_path(str(proj / 'train.py'), run_name='__main__')
            models[name] = tinfer.build_from_model_dir(str(tmp / name), device='cpu')
        jmodel = jinfer.build_from_model_dir(str(tmp / 'jax'))
        yield dict(tmp=tmp, root=root, logged=logged, models=models, jmodel=jmodel, proj=proj)


def test_created_project_trains_with_the_ports_script(workflow):
    assert 'import ever_tpu_torch as er' in (workflow['proj'] / 'train.py').read_text()
    for name in ('port', 'prefetched'):
        info = json.loads((workflow['tmp'] / name / 'checkpoint_info.json').read_text())
        assert info['last'] == dict(step=4, name='checkpoint-4.ckpt')
        assert workflow['models'][name][2] == 4


def test_logged_losses_match_jax(workflow):
    want, got = workflow['logged']['jax'], workflow['logged']['port']
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    for step in want:
        for k in ('cls_loss', 'total_loss', 'grad_norm'):
            np.testing.assert_allclose(got[step][k], want[step][k], rtol=2e-5,
                                       err_msg=f'{step} {k}')


def test_prefetched_run_is_bit_equal_to_the_normal_run(workflow):
    logged = workflow['logged']
    assert logged['prefetched'] == logged['port']
    (a, sa, _), (b, sb, _) = workflow['models']['port'], workflow['models']['prefetched']
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_served_model_dirs_give_jax_s_confusion_matrices(workflow):
    """Both packages rebuild the model from their model dir and serve the
    two validation scenes (64² tiles, stride 32): the confusion matrices of
    the argmax against the masks are equal."""
    from ever_tpu_torch.data.loveda import LoveDA

    tmodel, _, _ = workflow['models']['port']
    jmodel, jvars, jstep = workflow['jmodel']
    assert jstep == 4 and not tmodel.training
    val = LoveDA(dict(root=workflow['root'], split='val'))
    cms = []
    for predict in ('jax', 'port'):
        cm = np.zeros((CLASSES, CLASSES), np.int64)
        for i in range(len(val)):
            image, mask = val[i]
            if predict == 'jax':
                probs = np.asarray(jtiled(lambda v, t: jmodel.apply(v, t, train=False),
                                          jnp.asarray(image), 64, 32, CLASSES,
                                          tile_batch=4, variables=jvars))
            else:
                with torch.no_grad():
                    probs = ttiled(tmodel, image, 64, 32, CLASSES, tile_batch=4,
                                   device='cpu').numpy()
            np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
            ok = mask != 255
            cm += np.bincount(mask[ok] * CLASSES + probs.argmax(-1)[ok],
                              minlength=CLASSES * CLASSES).reshape(CLASSES, CLASSES)
        cms.append(cm)
    np.testing.assert_array_equal(cms[1], cms[0])
    assert cms[1].sum() == sum(int((val[i][1] != 255).sum()) for i in range(len(val)))
