"""The project CLI, the registry's directory registration, ``FrozenConfig``
and ``seed_everything`` against the JAX package."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import ever_tpu_torch
from ever_tpu.core import config as jconfig
from ever_tpu.util import seedlib as jseed
from ever_tpu_torch.core import config as tconfig
from ever_tpu_torch.core import registry
from ever_tpu_torch.util import seedlib as tseed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(ever_tpu_torch.__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, 'project_template', 'configs'))
                 if f.endswith('.py'))


def test_create_writes_port_scripts_and_copies_the_configs(tmp_path):
    r = subprocess.run([sys.executable, '-m', 'ever_tpu_torch', 'create', str(tmp_path / 'p')],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    proj = tmp_path / 'p'
    assert len(CONFIGS) == 6
    assert sorted(os.listdir(proj / 'configs')) == CONFIGS
    for name in CONFIGS:
        assert (proj / 'configs' / name).read_text() == open(
            os.path.join(REPO, 'project_template', 'configs', name)).read()
    assert (proj / 'module').is_dir() and (proj / 'data').is_dir()
    for script in ('train.py', 'infer.py'):
        text = (proj / script).read_text()
        assert 'import ever_tpu_torch as er' in text
        assert 'from ever_tpu_torch.core import registry' in text
        lines = [ln.strip() for ln in text.splitlines()]
        assert not any(ln.startswith(('import ever_tpu ', 'from ever_tpu.', 'import ever_tpu\n'))
                       or ln == 'import ever_tpu' for ln in lines)
        compile(text, script, 'exec')
    assert 'build_from_model_dir' in (proj / 'infer.py').read_text()


def test_register_dir_registers_a_project_module(tmp_path):
    module = tmp_path / 'proj' / 'module'
    (module / 'sub').mkdir(parents=True)
    (module / 'my_net.py').write_text(
        'from ever_tpu_torch.core import registry\n'
        '@registry.MODEL.register("torch_cli_net")\n'
        'class Net:\n    pass\n')
    (module / 'sub' / 'deep.py').write_text(
        'from ever_tpu_torch.core import registry\n'
        'registry.DATASET.register("torch_cli_deep", dict)\n')
    (module / '_private.py').write_text('raise RuntimeError("not imported")\n')
    registry.register_dir(str(module))
    assert 'torch_cli_net' in registry.MODEL and 'torch_cli_deep' not in registry.DATASET
    registry.register_dir(str(module), recursive=True)     # the same file is imported once
    assert registry.DATASET['torch_cli_deep'] is dict
    assert registry.MODEL['torch_cli_net'].__name__ == 'Net'
    (tmp_path / 'bad.py').write_text('raise ValueError("broken")\n')
    with pytest.raises(ValueError, match='broken'):
        registry.register_file(str(tmp_path / 'bad.py'))
    with pytest.raises(ValueError, match='broken'):       # a failed import is retried
        registry.register_file(str(tmp_path / 'bad.py'))


def test_register_all_takes_the_working_directorys_folders(tmp_path, monkeypatch):
    (tmp_path / 'data').mkdir()
    (tmp_path / 'data' / 'ds.py').write_text(
        'from ever_tpu_torch.core import registry\n'
        'registry.DATASET.register("torch_cli_all", list)\n')
    monkeypatch.chdir(tmp_path)
    registry.register_all()
    assert registry.DATASET['torch_cli_all'] is list


def test_frozen_config_matches_jax():
    base = dict(model=dict(type='DinoSeg', params=dict(classes=7)), lr=0.1, tags=[1, 2])
    j, t = jconfig.FrozenConfig(base), tconfig.FrozenConfig(base)
    assert t.to_dict() == j.to_dict()
    assert t.model.params.classes == j.model.params.classes == 7
    assert t['lr'] == j['lr'] and t.get('none', 3) == j.get('none', 3) == 3
    assert list(t) == list(j) and len(t) == len(j) and ('lr' in t) == ('lr' in j)
    assert sorted(t.keys()) == sorted(j.keys())
    for cfg in (j, t):
        with pytest.raises(AttributeError, match='read-only'):
            cfg.lr = 1.0
        with pytest.raises(AttributeError):
            cfg.missing  # noqa: B018
    assert t == tconfig.FrozenConfig(base) and hash(t) == hash(tconfig.FrozenConfig(base))
    assert repr(t) == repr(j)
    thawed = t.unfrozen()
    thawed.lr = 0.5
    assert t.lr == 0.1 and isinstance(thawed, tconfig.AttrDict)
    assert tconfig.to_dict(t) == jconfig.to_dict(j)


def test_from_pickle_reads_a_saved_config(tmp_path):
    cfg = tconfig.AttrDict(dict(a=dict(b=1)))
    tconfig.save_pkl(cfg, str(tmp_path / 'config.pkl'))
    assert tconfig.from_pickle(str(tmp_path / 'config.pkl')) == cfg


@pytest.mark.parametrize('kw', [dict(), dict(device_specific=True), dict(seed=5)])
def test_seed_everything_matches_jax(kw):
    draws = []
    for mod in (jseed, tseed):
        seed = mod.seed_everything(**kw)
        draws.append((seed, random.random(), float(np.random.random()),
                       float(torch.rand(()))))
    assert draws[0] == draws[1]
    for mod in (jseed, tseed):
        mod.worker_init_fn(2, 4, 1, seed=10)
        draws.append((random.random(), float(np.random.random())))
    assert draws[2] == draws[3]
