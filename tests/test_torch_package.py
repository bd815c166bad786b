"""Boundary checks of the PyTorch port: it imports neither JAX nor the JAX
package, shares the JAX package's tiling and configs, and never drops to
the CPU unless asked."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ever_tpu_torch
from ever_tpu.core import builder as jbuilder
from ever_tpu.core.config import AttrDict as JaxAttrDict
from ever_tpu.magic.sliding_window import sliding_window as jax_sliding_window
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core.checkpoint import CheckPoint
from ever_tpu_torch.core.config import AttrDict, import_config
from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.launcher import Launcher
from ever_tpu_torch.magic.sliding_window import sliding_window
from ever_tpu_torch.magic.tiled import tiled_inference
from ever_tpu_torch.trainer import Trainer, get_trainer, parse_args

PKG = os.path.dirname(os.path.abspath(ever_tpu_torch.__file__))
REPO = os.path.dirname(PKG)


def test_import_pulls_in_neither_jax_nor_ever_tpu():
    code = ('import sys, ever_tpu_torch, ever_tpu_torch.util.weight_io,'
            ' ever_tpu_torch.opt, ever_tpu_torch.parallel.spmd,'
            ' ever_tpu_torch.module.loss, ever_tpu_torch.ops._build,'
            ' ever_tpu_torch.ops.pool, ever_tpu_torch.module.fs_relation,'
            ' ever_tpu_torch.ops.norm, ever_tpu_torch.ops.quant,'
            ' ever_tpu_torch.trainer, ever_tpu_torch.metric, ever_tpu_torch.data,'
            ' ever_tpu_torch.core.launcher, ever_tpu_torch.magic.transform;'
            'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
            ' or m == "ever_tpu" or m.startswith("ever_tpu.")];'
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_source_has_no_jax_or_ever_tpu_import():
    bad = re.compile(r'^\s*(import\s+(jax|flax|ever_tpu)\b(?!_torch)'
                     r'|from\s+(jax|flax|ever_tpu)\b(?!_torch))', re.M)
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files if n.endswith('.py')]
    for path in paths:
        with open(path) as f:
            assert not bad.search(f.read()), path
    scanned = {os.path.relpath(p, REPO) for p in paths}
    assert len(scanned) >= 33
    assert {'chip_smoke.py', 'ever_tpu_torch/ops/attention.py',
            'ever_tpu_torch/opt/optimizer.py', 'ever_tpu_torch/opt/learning_rate.py',
            'ever_tpu_torch/interface/learning_rate.py',
            'ever_tpu_torch/module/loss.py',
            'ever_tpu_torch/parallel/spmd.py', 'ever_tpu_torch/ops/pool.py',
            'ever_tpu_torch/module/resnet.py', 'ever_tpu_torch/module/fpn.py',
            'ever_tpu_torch/module/fs_relation.py', 'ever_tpu_torch/ops/norm.py',
            'ever_tpu_torch/ops/quant.py', 'ever_tpu_torch/core/launcher.py',
            'ever_tpu_torch/core/checkpoint.py', 'ever_tpu_torch/trainer/trainer.py',
            'ever_tpu_torch/metric/evaluate_fn.py', 'ever_tpu_torch/data/distributed.py',
            'ever_tpu_torch/magic/_transform_impl.py'} <= scanned


@pytest.mark.parametrize('size,k,s', [((200, 150), 64, 48), ((40, 50), 64, 32),
                                      ((4096, 4096), 512, 512), ((97, 1000), (32, 64), (16, 60))])
def test_sliding_window_boxes_equal_jax(size, k, s):
    np.testing.assert_array_equal(sliding_window(size, k, s),
                                  jax_sliding_window(size, k, s))


def test_same_config_builds_dinoseg_in_both_registries():
    cfg = dict(backbone=dict(name='vit_small', attn_impl='xla'), classes=5,
               head=dict(n_taps=2))
    jm = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    tm = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    assert jm.config.to_dict() == tm.config.to_dict()
    assert tm.vit.depth == 12 and tm.vit.embed_dim == 384
    assert tm.head_classifier.out_features == 5
    assert tm.head_classifier.in_features == 2 * 384


def test_attrdict_overrides_match_jax(tmp_path):
    base = dict(model=dict(type='DinoSeg', params=dict(classes=7)), flag=False)
    opts = ['model.params.classes', '5', 'flag', 'TRUE', 'new.key', 'null',
            'name', 'plain-string']
    assert AttrDict(base).update_from_list(opts).to_dict() == \
        JaxAttrDict(base).update_from_list(opts).to_dict()
    path = tmp_path / 'cfg.py'
    path.write_text('config = dict(model=dict(type="DinoSeg", params=dict(classes=3)))\n')
    cfg = import_config(str(path))
    assert cfg.model.params.classes == 3
    with pytest.raises(FileNotFoundError):
        import_config(str(tmp_path / 'missing.py'))


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tbuilder.make_model({'type': 'vit_small', 'params': {}})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tiled_inference(lambda t: t, np.zeros((8, 8, 1), np.float32), 8, 8, 1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tiled_inference(lambda t: t, np.zeros((8, 8, 1), np.float32), 8, 8, 1, tta='d4')
    cfg = tmp_path / 'cfg.py'
    cfg.write_text('config = dict(model=dict(type="DinoSeg", params=dict(classes=3)))\n')
    argv = ['--config_path', str(cfg), '--model_dir', str(tmp_path / 'run')]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_trainer('th_ddp', argv=argv)()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(parse_args(argv))
    assert not (tmp_path / 'run').exists()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Launcher(str(tmp_path / 'run'), torch.nn.Linear(2, 2), None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CheckPoint.load(str(tmp_path / 'missing.ckpt'))
    assert get_device('cpu') == torch.device('cpu')
    out = tiled_inference(lambda t: t, np.ones((8, 8, 1), np.float32), 8, 8, 1,
                          device='cpu')
    assert out.device.type == 'cpu' and float(out.min()) == 1.0
    out = tiled_inference(lambda t: t, np.ones((8, 8, 1), np.float32), 8, 8, 1,
                          tta='d4', device='cpu')
    assert out.device.type == 'cpu' and float(out.min()) == 1.0
    trainer = get_trainer('th_ddp', argv=argv + ['--device', 'cpu'])()
    assert trainer.device == torch.device('cpu') and (tmp_path / 'run' / 'config.pkl').exists()


def _pallas_kernels():
    """{'ever_tpu/<path>:<line>'} of every function the JAX package hands to
    ``pl.pallas_call`` (by name or through ``functools.partial``): the
    def line of each TPU kernel."""
    import ast
    found = set()
    root = os.path.join(REPO, 'ever_tpu')
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            defs = {n.name: n.lineno for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef)}
            for call in ast.walk(tree):
                if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                        and call.func.attr == 'pallas_call' and call.args):
                    continue
                kernel = call.args[0]
                if isinstance(kernel, ast.Call) and kernel.args:   # functools.partial(f, ...)
                    kernel = kernel.args[0]
                assert isinstance(kernel, ast.Name) and kernel.id in defs, (path, call.lineno)
                found.add(f'{os.path.relpath(path, REPO)}:{defs[kernel.id]}')
    return found


def test_every_tpu_kernel_has_one_chip_smoke_record_and_no_record_names_another():
    """Each ``replaces='ever_tpu/...:line'`` of chip_smoke.py's kernel
    records names a function that reaches ``pl.pallas_call`` in the JAX
    package, and each such function has exactly one record."""
    with open(os.path.join(REPO, 'chip_smoke.py')) as f:
        records = re.findall(r"replaces='(ever_tpu/[^']+)'", f.read())
    kernels = _pallas_kernels()
    assert len(kernels) == 7
    assert sorted(records) == sorted(kernels)
