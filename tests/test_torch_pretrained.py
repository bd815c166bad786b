"""The pretrained workflow of the port's ``ERModule`` against the JAX
package's (``ever_tpu/interface/module.py``), on the CPU.

``save_pretrained`` writes the ``config.json`` the JAX package writes for
the same config and the ``state_dict``; ``from_pretrained`` rebuilds the
model, its weights and outputs equal to the bit; ``push_to_hub`` hands a
``from_pretrained`` directory to ``huggingface_hub``, here a recording
fake (no network), and without the package raises the JAX package's
offline recipe.  Then ``GLOBAL_KEY``, ``global_config`` and ``log_info``.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.interface import module as jmodule
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.interface import module as tmodule
from ever_tpu_torch.interface.module import ERModule
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SPEC = {'type': 'FreeNet', 'params': dict(in_channels=6, stage_channels=(8, 8, 16, 16),
                                          classes=3, GLOBAL=dict(weight=dict(path=None)))}


def _model():
    torch.manual_seed(0)
    return tbuilder.make_model(SPEC, device='cpu')


def test_save_and_from_pretrained_round_trip(tmp_path):
    model = _model()
    x = torch.randn(1, 20, 18, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
    model.save_pretrained(str(tmp_path / 'hub'))
    assert sorted(os.listdir(tmp_path / 'hub')) == ['config.json', 'pytorch_model.bin']
    # the JAX package writes the same config.json for the same config
    jm = jbuilder.make_model(SPEC)
    jm.save_pretrained(str(tmp_path / 'jax'), {})
    with open(tmp_path / 'hub' / 'config.json') as f, open(tmp_path / 'jax' / 'config.json') as g:
        assert json.load(f) == json.load(g)
    m2, state = ERModule.from_pretrained(str(tmp_path / 'hub'), device='cpu')
    assert type(m2) is type(model) and m2.config.classes == 3
    assert tmodule._jsonable(m2.config) == jmodule._jsonable(jm.config)
    sd = model.state_dict()
    assert list(state) == list(sd)
    for k, v in sd.items():
        assert v.dtype == state[k].dtype and torch.equal(v, state[k]), k
    with torch.no_grad():
        assert torch.equal(m2(x), want)
    # a given state_dict is what is written
    zeros = {k: torch.zeros_like(v) for k, v in sd.items()}
    model.save_pretrained(str(tmp_path / 'zeros'), zeros)
    _, state = ERModule.from_pretrained(str(tmp_path / 'zeros'), device='cpu')
    assert all(not v.any() for v in state.values())


def test_save_pretrained_needs_a_registered_class(tmp_path):
    class Unregistered(ERModule):
        pass

    with pytest.raises(ValueError, match='not registered'):
        Unregistered().save_pretrained(str(tmp_path))


def test_push_to_hub_against_a_recording_fake(tmp_path, monkeypatch):
    model = _model()
    calls = []

    class FakeApi:
        def __init__(self, token=None):
            calls.append(('init', token))

        def create_repo(self, repo_id, private=False, exist_ok=False):
            calls.append(('create_repo', repo_id, private, exist_ok))

        def upload_folder(self, repo_id, folder_path, commit_message=None):
            m2, state = ERModule.from_pretrained(folder_path, device='cpu')
            assert m2.config.classes == 3 and state
            calls.append(('upload_folder', repo_id, commit_message))
            return f'https://hub/{repo_id}'

    monkeypatch.setitem(sys.modules, 'huggingface_hub', types.SimpleNamespace(HfApi=FakeApi))
    assert model.push_to_hub('user/freenet', token='tok') == 'https://hub/user/freenet'
    assert calls[0] == ('init', 'tok')
    assert ('create_repo', 'user/freenet', False, True) in calls
    model.save_pretrained(str(tmp_path / 'hub'))
    model.push_to_hub('user/freenet2', save_directory=str(tmp_path / 'hub'), create_repo=False)
    assert calls[-1] == ('upload_folder', 'user/freenet2', 'upload FreeNet (ever_tpu_torch)')
    with pytest.raises(ValueError, match='at most one'):
        model.push_to_hub('user/x', model.state_dict(), save_directory=str(tmp_path / 'hub'))
    with pytest.raises(ValueError, match='no config.json'):
        model.push_to_hub('user/x', save_directory=str(tmp_path))


def test_push_to_hub_without_the_package_raises_the_offline_recipe(monkeypatch):
    monkeypatch.setitem(sys.modules, 'huggingface_hub', None)
    with pytest.raises(RuntimeError) as port:
        _model().push_to_hub('user/x')
    with pytest.raises(RuntimeError) as ref:
        jbuilder.make_model(SPEC).push_to_hub('user/x', {})
    assert str(port.value) == str(ref.value) and 'offline recipe' in str(port.value)


def test_global_config_and_log_info():
    model = _model()
    assert tmodule.GLOBAL_KEY == jmodule.GLOBAL_KEY == 'GLOBAL'
    assert model.global_config.weight.path is None
    assert ERModule().global_config == {}
    assert model.log_info() == {}
    assert np.array_equal(sorted(tmodule.__all__), sorted(jmodule.__all__))
