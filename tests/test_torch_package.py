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
from ever_tpu_torch.api import infer_tool
from ever_tpu_torch.core.iterator import get_iterator
from ever_tpu_torch.core.launcher import Launcher
from ever_tpu_torch.core.prefetch import prefetch_to_device
from ever_tpu_torch.util.weight_io import load_weights
from ever_tpu_torch.magic.sliding_window import sliding_window
from ever_tpu_torch.magic.tiled import tiled_inference
from ever_tpu_torch.core.dist import init_dist_env
from ever_tpu_torch.parallel.mesh import make_mesh
from ever_tpu_torch.parallel.spmd import create_train_state
from ever_tpu_torch.parallel.zero import zero_init
from ever_tpu_torch.trainer import SPMDTrainer, Trainer, get_trainer, parse_args

PKG = os.path.dirname(os.path.abspath(ever_tpu_torch.__file__))
REPO = os.path.dirname(PKG)


def test_import_pulls_in_neither_jax_nor_ever_tpu():
    code = ('import sys, ever_tpu_torch, ever_tpu_torch.util.weight_io,'
            ' ever_tpu_torch.opt, ever_tpu_torch.parallel.spmd,'
            ' ever_tpu_torch.module.loss, ever_tpu_torch.ops._build,'
            ' ever_tpu_torch.ops.pool, ever_tpu_torch.module.fs_relation,'
            ' ever_tpu_torch.ops.norm, ever_tpu_torch.ops.quant,'
            ' ever_tpu_torch.trainer, ever_tpu_torch.metric, ever_tpu_torch.data,'
            ' ever_tpu_torch.core.launcher, ever_tpu_torch.magic.transform,'
            ' ever_tpu_torch.data._png, ever_tpu_torch.data._tilekit,'
            ' ever_tpu_torch.data._scene, ever_tpu_torch.data.loveda,'
            ' ever_tpu_torch.data.geotile, ever_tpu_torch.data.cross_validation,'
            ' ever_tpu_torch.core.to, ever_tpu_torch.core.prefetch,'
            ' ever_tpu_torch.core.iterator, ever_tpu_torch.util.seedlib,'
            ' ever_tpu_torch.util.param_util, ever_tpu_torch.util._main,'
            ' ever_tpu_torch.api.infer_tool, ever_tpu_torch.__main__,'
            ' ever_tpu_torch.core.dist, ever_tpu_torch.parallel.mesh,'
            ' ever_tpu_torch.trainer.th_ddp_trainer, ever_tpu_torch.module.se_block,'
            ' ever_tpu_torch.module.context_block, ever_tpu_torch.module.vit,'
            ' ever_tpu_torch.module.factseg, ever_tpu_torch.module.change,'
            ' ever_tpu_torch.data.benchmarks, ever_tpu_torch.preprocess,'
            ' ever_tpu_torch.preprocess.segm, ever_tpu_torch.preprocess.function,'
            ' ever_tpu_torch.preprocess.albu, ever_tpu_torch.preprocess.comm,'
            ' ever_tpu_torch.preprocess.thcomm, ever_tpu_torch.preprocess.thsegm,'
            ' ever_tpu_torch.preprocess.device, ever_tpu_torch.core.logger,'
            ' ever_tpu_torch.ops.ptq, ever_tpu_torch.module.misc, ever_tpu_torch.magic.bigimage,'
            ' ever_tpu_torch.magic.bigimage.sliding_window, ever_tpu_torch.util.lr_search,'
            ' ever_tpu_torch.module.heads, ever_tpu_torch.module.hrnet,'
            ' ever_tpu_torch.module.aspp, ever_tpu_torch.module.ppm,'
            ' ever_tpu_torch.module.deeplabv3p_head, ever_tpu_torch.module.hrnet_head,'
            ' ever_tpu_torch.module._hrnet, ever_tpu_torch.module._resnets,'
            ' ever_tpu_torch.module.efficientnet, ever_tpu_torch.module.densenet,'
            ' ever_tpu_torch.module._densenet, ever_tpu_torch.module.resnest,'
            ' ever_tpu_torch.module.convnext, ever_tpu_torch.module.freenet,'
            ' ever_tpu_torch.module.dinov3, ever_tpu_torch.module.dinov3.layers.fp8_linear,'
            ' ever_tpu_torch.module.dinov3.models.convnext, ever_tpu_torch.module.dinov3.utils,'
            ' ever_tpu_torch.module.dinov3.utils.cluster,'
            ' ever_tpu_torch.module.dinov3.utils.custom_callable,'
            ' ever_tpu_torch.module.dinov3.utils.dtype, ever_tpu_torch.module.gan,'
            ' ever_tpu_torch.trainer.gan, ever_tpu_torch.parallel.zero,'
            ' ever_tpu_torch.parallel.sharded, ever_tpu_torch.parallel.tp,'
            ' ever_tpu_torch.parallel.pp, ever_tpu_torch.parallel.ep,'
            ' ever_tpu_torch.parallel.spatial, ever_tpu_torch.util.eda;'
            'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
            ' or m == "ever_tpu" or m.startswith("ever_tpu.")'
            ' or m == "PIL" or m.startswith("PIL.")];'
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_source_has_no_jax_or_ever_tpu_import():
    bad = re.compile(r'^\s*(import\s+(jax|flax|ever_tpu|PIL)\b(?!_torch)'
                     r'|from\s+(jax|flax|ever_tpu|PIL)\b(?!_torch))', re.M)
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files if n.endswith('.py')]
    for path in paths:
        with open(path) as f:
            assert not bad.search(f.read()), path
    scanned = {os.path.relpath(p, REPO) for p in paths}
    assert len(scanned) >= 64
    assert {'chip_smoke.py', 'ever_tpu_torch/ops/attention.py',
            'ever_tpu_torch/opt/optimizer.py', 'ever_tpu_torch/opt/learning_rate.py',
            'ever_tpu_torch/interface/learning_rate.py',
            'ever_tpu_torch/module/loss.py',
            'ever_tpu_torch/parallel/spmd.py', 'ever_tpu_torch/ops/pool.py',
            'ever_tpu_torch/module/resnet.py', 'ever_tpu_torch/module/fpn.py',
            'ever_tpu_torch/module/se_block.py', 'ever_tpu_torch/module/context_block.py',
            'ever_tpu_torch/module/fs_relation.py', 'ever_tpu_torch/ops/norm.py',
            'ever_tpu_torch/ops/quant.py', 'ever_tpu_torch/core/launcher.py',
            'ever_tpu_torch/core/checkpoint.py', 'ever_tpu_torch/trainer/trainer.py',
            'ever_tpu_torch/metric/evaluate_fn.py', 'ever_tpu_torch/data/distributed.py',
            'ever_tpu_torch/magic/_transform_impl.py', 'ever_tpu_torch/data/_png.py',
            'ever_tpu_torch/data/_tilekit.py', 'ever_tpu_torch/data/_scene.py',
            'ever_tpu_torch/data/loveda.py', 'ever_tpu_torch/data/geotile.py',
            'ever_tpu_torch/data/cross_validation.py', 'ever_tpu_torch/core/to.py',
            'ever_tpu_torch/core/prefetch.py', 'ever_tpu_torch/util/seedlib.py',
            'ever_tpu_torch/util/param_util.py', 'ever_tpu_torch/util/_main.py',
            'ever_tpu_torch/api/infer_tool.py', 'ever_tpu_torch/__main__.py',
            'ever_tpu_torch/core/dist.py', 'ever_tpu_torch/core/device.py',
            'ever_tpu_torch/parallel/mesh.py', 'ever_tpu_torch/module/ops.py',
            'ever_tpu_torch/magic/tiled.py',
            'ever_tpu_torch/trainer/th_ddp_trainer.py', 'ever_tpu_torch/module/factseg.py',
            'ever_tpu_torch/module/change.py', 'ever_tpu_torch/data/benchmarks.py',
            'ever_tpu_torch/core/logger.py', 'ever_tpu_torch/metric/utils.py',
            'ever_tpu_torch/preprocess/__init__.py', 'ever_tpu_torch/preprocess/segm.py',
            'ever_tpu_torch/preprocess/function.py', 'ever_tpu_torch/preprocess/albu.py',
            'ever_tpu_torch/preprocess/comm.py', 'ever_tpu_torch/preprocess/thcomm.py',
            'ever_tpu_torch/preprocess/thsegm.py', 'ever_tpu_torch/preprocess/device.py',
            'ever_tpu_torch/ops/ptq.py', 'ever_tpu_torch/module/misc.py',
            'ever_tpu_torch/magic/bigimage/__init__.py',
            'ever_tpu_torch/magic/bigimage/sliding_window.py',
            'ever_tpu_torch/util/lr_search.py', 'ever_tpu_torch/module/efficientnet.py',
            'ever_tpu_torch/module/densenet.py', 'ever_tpu_torch/module/_densenet.py',
            'ever_tpu_torch/module/resnest.py', 'ever_tpu_torch/module/convnext.py',
            'ever_tpu_torch/module/freenet.py', 'ever_tpu_torch/module/dinov3/__init__.py',
            'ever_tpu_torch/module/dinov3/layers/fp8_linear.py',
            'ever_tpu_torch/module/dinov3/layers/sparse_linear.py',
            'ever_tpu_torch/module/dinov3/utils/utils.py', 'ever_tpu_torch/module/gan.py',
            'ever_tpu_torch/trainer/gan.py', 'ever_tpu_torch/parallel/zero.py',
            'ever_tpu_torch/parallel/sharded.py', 'ever_tpu_torch/parallel/tp.py',
            'ever_tpu_torch/parallel/pp.py', 'ever_tpu_torch/parallel/ep.py',
            'ever_tpu_torch/parallel/spatial.py', 'ever_tpu_torch/util/eda.py'} <= scanned


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
    # the data-parallel entry points: the process group's backend follows
    # the device (nccl for the card), a torchrun rank's card is its own
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('RANK', '0')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_dist_env()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SPMDTrainer(parse_args(argv))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_trainer('gan_th_ddp', argv=argv)()
    monkeypatch.delenv('WORLD_SIZE')
    monkeypatch.delenv('RANK')
    assert not torch.distributed.is_initialized()
    # the parallel slice's: a ZeRO state is placed on the card, a directory
    # checkpoint read onto it
    lin = torch.nn.Linear(4, 2)
    state = create_train_state(lin, tbuilder.make_optimizer(
        {'type': 'sgd', 'params': {}})[0].build(0.1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        zero_init(state, make_mesh())
    ckpt_dir = tmp_path / 'dir-ckpt'
    CheckPoint.save_sharded(str(ckpt_dir), state)
    assert CheckPoint(backend='orbax').backend == 'orbax'
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CheckPoint.load(str(ckpt_dir))
    assert CheckPoint.load(str(ckpt_dir), device='cpu')['model']['weight'].shape == (2, 4)
    assert zero_init(state, make_mesh(), device='cpu')[1].level == 1
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tiled_inference(lambda t: t, np.zeros((8, 8, 1), np.float32), 8, 8, 1,
                        mesh=make_mesh())
    # the model-parallel layouts: the shards, stages and experts go to the card
    from ever_tpu_torch.module.vit import DinoVisionTransformer
    from ever_tpu_torch.parallel.ep import MoEMlp
    from ever_tpu_torch.parallel.pp import pipelined_vit_apply
    from ever_tpu_torch.parallel.tp import apply_tp
    vit = DinoVisionTransformer('vit_small', n_storage_tokens=0)
    one = make_mesh(('data', 'model'), (1, 1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        apply_tp(vit, one)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pipelined_vit_apply(vit, None, make_mesh(('pipe',)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MoEMlp(4, 8, dim=8)
    assert apply_tp(vit, one, device='cpu') is vit
    assert pipelined_vit_apply(vit, None, make_mesh(('pipe',)), device='cpu').block_ids == \
        list(range(12))
    assert MoEMlp(4, 8, dim=8, device='cpu').router.device.type == 'cpu'
    # the spatial layouts: the strips go to the card
    from ever_tpu_torch.parallel.spatial import (build_halo_train_step,
                                                 build_spatial_train_step,
                                                 spatial_partition_apply)
    tile = np.ones((1, 8, 8, 3), np.float32)
    rule = tbuilder.make_optimizer({'type': 'sgd', 'params': {}})[0].build(0.1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        spatial_partition_apply(lambda t: t, tile, make_mesh(), halo=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_spatial_train_step(lin, rule, mesh=make_mesh())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_halo_train_step(lambda p, t: t, lambda o, t: o.mean(), rule, make_mesh())
    got = spatial_partition_apply(lambda t: 2 * t, tile, make_mesh(), halo=1, device='cpu')
    assert got.device.type == 'cpu' and float(got.min()) == 2.0
    assert callable(build_spatial_train_step(lin, rule, mesh=make_mesh(), device='cpu'))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'set_device', lambda d: None)
    monkeypatch.setenv('LOCAL_RANK', '1')
    with pytest.raises(RuntimeError, match='LOCAL_RANK 1 but 1 CUDA'):
        get_device()
    assert get_device('cuda:0') == torch.device('cuda', 0)       # named: shared
    monkeypatch.setenv('LOCAL_RANK', '0')
    assert get_device() == get_device('cuda') == torch.device('cuda', 0)
    monkeypatch.delenv('LOCAL_RANK')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert get_device('cpu') == torch.device('cpu')
    out = tiled_inference(lambda t: t, np.ones((8, 8, 1), np.float32), 8, 8, 1,
                          device='cpu')
    assert out.device.type == 'cpu' and float(out.min()) == 1.0
    out = tiled_inference(lambda t: t, np.ones((8, 8, 1), np.float32), 8, 8, 1,
                          tta='d4', device='cpu')
    assert out.device.type == 'cpu' and float(out.min()) == 1.0
    trainer = get_trainer('th_ddp', argv=argv + ['--device', 'cpu'])()
    assert trainer.device == torch.device('cpu') and (tmp_path / 'run' / 'config.pkl').exists()
    # the workflow's entry points: serving a model dir, prefetching, weights
    torch.save({'model': {}, 'opt': {}, 'global_step': 1}, tmp_path / 'run' / 'checkpoint-1.ckpt')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        infer_tool.build_from_model_dir(str(tmp_path / 'run'))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        infer_tool.build_and_load_from_file(str(cfg), str(tmp_path / 'run' / 'checkpoint-1.ckpt'))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        prefetch_to_device(iter([np.zeros(2)]))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_iterator('prefetched')([np.zeros(2)])
    torch.save({'weight': torch.ones(2, 2)}, tmp_path / 'w.pth')
    lin = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_weights(str(tmp_path / 'w.pth'), lin)
    assert [t.device.type for t in prefetch_to_device(iter([np.zeros(2)]), device='cpu')] == ['cpu']
    assert load_weights(str(tmp_path / 'w.pth'), lin, device='cpu').loaded == 1
    assert float(lin.weight.min()) == 1.0


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


# the public names of the JAX subpackages' __init__s that the port does not
# have yet, each with its ROADMAP.md A item
NOT_PORTED = {
    'core': {}, 'interface': {}, 'opt': {}, 'preprocess': {},
    'magic': {},
    'module': {},
    'ops': {},
    'parallel': {},
}


# the registry names the port does not have yet, each with its ROADMAP.md A item
REGISTRY_NOT_PORTED = {}


def test_registries_match_jax_or_name_their_roadmap_item():
    """The names in the port's ``registry.OP`` and ``registry.MODEL`` after
    importing ``ever_tpu_torch.module`` are the JAX package's after
    importing ``ever_tpu.module``, but those listed with their
    ``ROADMAP.md`` A item; the port has no name of its own.  In a fresh
    interpreter, so that no other test's registrations count."""
    import json
    code = ('import json, ever_tpu.module, ever_tpu_torch.module\n'
            'from ever_tpu.core import registry as j\n'
            'from ever_tpu_torch.core import registry as t\n'
            'print(json.dumps({r: [sorted(getattr(j, r)), sorted(getattr(t, r))]'
            ' for r in ("OP", "MODEL")}))\n')
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    names = json.loads(r.stdout.strip().splitlines()[-1])
    with open(os.path.join(REPO, 'ROADMAP.md')) as f:
        roadmap = f.read()
    for reg, (jax_names, port_names) in names.items():
        assert set(port_names) - set(jax_names) == set(), reg
        missing = set(jax_names) - set(port_names)
        assert missing <= set(REGISTRY_NOT_PORTED), (reg, missing - set(REGISTRY_NOT_PORTED))
        for name in missing:
            assert f'**{REGISTRY_NOT_PORTED[name]}' in roadmap, name
    assert {'FPN', 'AssymetricDecoder', 'SEBlock', 'SCSEModule', 'ContextBlock2d',
            'FSRelation', 'FSRelationV2', 'Fusion', 'BiFPN',
            'SpectralAttention'} <= set(names['OP'][1])
    assert {'ViTEncoder', 'FreeNet', 'DCGAN'} <= set(names['MODEL'][1])
    assert 'resnet_frozen_prefixes' not in names['MODEL'][1]
    assert set(REGISTRY_NOT_PORTED) <= set(names['OP'][0]) | set(names['MODEL'][0])


def _init_names(package: str):
    """The public names the JAX ``ever_tpu/{package}/__init__.py`` binds:
    what it imports and assigns."""
    import ast
    with open(os.path.join(REPO, 'ever_tpu', package, '__init__.py')) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split('.')[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith('_') and n != 'annotations'}


@pytest.mark.parametrize('package', sorted(NOT_PORTED))
def test_subpackage_surfaces_match_jax_or_name_their_roadmap_item(package):
    """Every public name of the JAX subpackage's ``__init__`` imports from
    the port's subpackage, or is listed here with its ``ROADMAP.md`` A
    item (and then the port has no such name yet); no listed name is
    ported, and no name is stubbed.  ``ops.attention`` is the kernels'
    module in the port, the function ``attention_fn``."""
    import importlib
    port = importlib.import_module(f'ever_tpu_torch.{package}')
    missing = NOT_PORTED[package]
    with open(os.path.join(REPO, 'ROADMAP.md')) as f:
        roadmap = f.read()
    names = _init_names(package)
    assert names and set(missing) <= names
    for name in sorted(names):
        if name in missing:
            assert not hasattr(port, name), f'{package}.{name} is ported: unlist it'
            assert f'**{missing[name]}' in roadmap, (name, missing[name])
        else:
            assert hasattr(port, name), f'{package}.{name} is neither ported nor listed'


# names in a shared module's JAX ``__all__`` that the port's module does not
# have, each with its ROADMAP.md A item, or the reason it has none (each
# named in ROADMAP.md §C's deviations)
MODULE_NOT_PORTED = {
    'core.device': {'tpu_device': 'TPU-only'},
    'core.to': {'tpu_device': 'TPU-only'},
    'ops.pool': {'max_pool_32_pallas': 'TPU-only'},
    'opt.optimizer': {'find_recorded_grad_norm': "optax's state",
                      'ClipByGlobalNormState': "optax's state"},
}


def _shared_modules():
    """The dotted names (below the package) of every module of the JAX
    package that the port has at the same path."""
    out = []
    root = os.path.join(REPO, 'ever_tpu')
    for dirpath, _, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if name.endswith('.py') and os.path.exists(os.path.join(PKG, rel)):
                mod = rel[:-3].replace(os.sep, '.')
                out.append(mod[:-len('.__init__')] if mod.endswith('.__init__')
                           else '' if mod == '__init__' else mod)
    return sorted(out)


def _import_keeping_parent(name: str):
    """``importlib.import_module(name)``, and the name it binds on its
    package put back: a first import of ``magic.transform.tta`` sets the
    package's ``tta`` to the submodule, over the function of that name, and
    every later ``transform.tta(...)`` of the process would call a module
    (the two TTA tests of ``test_torch_transform.py`` failed so after this
    file in one xdist worker)."""
    import importlib
    parent_name, _, child = name.rpartition('.')
    parent = importlib.import_module(parent_name) if parent_name else None
    missing = object()
    before = vars(parent).get(child, missing) if parent is not None else missing
    mod = importlib.import_module(name)
    if before is not missing and vars(parent).get(child) is not before:
        setattr(parent, child, before)
    return mod


@pytest.mark.parametrize('module', _shared_modules(), ids=lambda m: m or 'ever_tpu')
def test_module_all_matches_jax_or_names_its_reason(module):
    """Every name in the JAX module's ``__all__`` is an attribute of the
    port's module at the same path, or is listed in ``MODULE_NOT_PORTED``
    with its ``ROADMAP.md`` A item or its deviation (then the port has no
    such name, and ROADMAP.md names it)."""
    dotted = f'.{module}' if module else ''
    jm = _import_keeping_parent('ever_tpu' + dotted)
    port = _import_keeping_parent('ever_tpu_torch' + dotted)
    names = getattr(jm, '__all__', [])
    missing = MODULE_NOT_PORTED.get(module, {})
    assert set(missing) <= set(names)
    with open(os.path.join(REPO, 'ROADMAP.md')) as f:
        roadmap = f.read()
    for name in names:
        if name in missing:
            assert not hasattr(port, name), f'{module}.{name} is ported: unlist it'
            reason = missing[name]
            assert (f'**{reason}' if reason.startswith('A.') else f'`{name}`') in roadmap, name
        else:
            assert hasattr(port, name), f'{module}.{name} is neither ported nor listed'


def test_the_tta_submodules_leave_both_packages_tta_functions():
    """The module-surface case of ``magic.transform.tta`` run on a fresh
    import of the JAX package's submodule (the first import, as in a
    worker that had run no TTA yet), then both packages' ``tta`` and
    ``d4_tta`` called: functions still, equal on a row-dependent stub."""
    import sys
    from ever_tpu.magic import transform as jt
    from ever_tpu_torch.magic import transform as tt
    saved = sys.modules.pop('ever_tpu.magic.transform.tta', None)
    try:
        test_module_all_matches_jax_or_names_its_reason('magic.transform.tta')
        assert callable(jt.tta) and callable(tt.tta), (jt.tta, tt.tta)
        x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
        row = np.linspace(0.5, 1.5, 8, dtype=np.float32)[None, :, None, None]
        want = np.asarray(jt.tta(lambda a: a * row, x, [jt.Identity(), jt.HorizontalFlip()]))
        got = tt.tta(lambda a: a * torch.from_numpy(row), torch.from_numpy(x),
                     [tt.Identity(), tt.HorizontalFlip()])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt.d4_tta(lambda a: a, torch.from_numpy(x)).numpy(), x,
                                   rtol=0, atol=1e-6)
    finally:
        if saved is not None:
            sys.modules['ever_tpu.magic.transform.tta'] = saved


def test_documented_imports_work_under_the_port_s_name():
    """``docs/USAGE.md``'s module import and the other re-exports the JAX
    package's users write, under ``ever_tpu_torch``, without JAX."""
    code = ('import sys\n'
            'from ever_tpu_torch.module import ResNetEncoder, FarSegHead, loss as L\n'
            'from ever_tpu_torch.module import FactSeg, ChangeStar, ChangeMask, ChangeOS\n'
            'from ever_tpu_torch.magic import tta, d4_tta\n'
            'from ever_tpu_torch.parallel import build_train_step, make_mesh\n'
            'from ever_tpu_torch.core import AttrDict, import_config, registry\n'
            'from ever_tpu_torch.ops import QuantDense, attention_fn\n'
            'from ever_tpu_torch.ops import ptq_quantize, make_ptq_predict_fn\n'
            'from ever_tpu_torch.module import PadCropWrapper\n'
            'from ever_tpu_torch.magic import pad_crop_apply\n'
            'from ever_tpu_torch.magic.bigimage import sliding_window\n'
            'from ever_tpu_torch.data import LEVIRCD, XView2, ISAID\n'
            'assert callable(L.binary_cross_entropy_with_logits)\n'
            'assert "ChangeMixin" in registry.OP and "FactSeg" in registry.MODEL\n'
            'assert {"levircd", "xview2", "isaid"} <= set(registry.DATASET)\n'
            'sys.exit(any(m == "jax" or m.startswith(("jax.", "ever_tpu."))\n'
            '             for m in sys.modules))\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
