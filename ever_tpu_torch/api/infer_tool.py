"""Build a trained model for inference (counterpart of
``ever_tpu/api/infer_tool.py``): from a config file, from a config and a
checkpoint, or from a training run's model dir.

Each returns the JAX package's triple ``(model, variables, step)``:
``model`` holds the checkpoint's weights, is in eval mode and sits on
``device`` (the GPU unless ``device='cpu'``); ``variables`` is its
``state_dict``.  A model dir's checkpoint is ``model-best.ckpt`` when there
is one (``step`` is then ``'best'``), else the one ``checkpoint_info.json``
names as ``last``, else the highest ``checkpoint-N.ckpt``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from ever_tpu_torch.core import checkpoint as ckpt_lib
from ever_tpu_torch.core.builder import make_model
from ever_tpu_torch.core.config import import_config
from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.logger import info

__all__ = ['build_from_file', 'build_and_load_from_file', 'build_from_model_dir',
           'export_model']

Device = Optional[Union[str, torch.device]]


def build_from_file(config_path: str, device: Device = None) -> torch.nn.Module:
    """The config's model on ``device``, in eval mode, with its initial
    weights."""
    cfg = import_config(config_path)
    return make_model(cfg['model'], device=device).eval()


def _load_state(checkpoint_path: str, device) -> Tuple[dict, int]:
    obj = ckpt_lib.CheckPoint.load(checkpoint_path, device)
    if ckpt_lib.is_checkpoint(obj):
        return obj[ckpt_lib.MODEL], int(obj[ckpt_lib.GLOBALSTEP])
    try:
        step = int(Path(checkpoint_path).name.split('.')[0].split('-')[1])
    except (IndexError, ValueError):
        step = 0
    return obj, step


def build_and_load_from_file(config_path: str, checkpoint_path: str,
                             device: Device = None):
    """``(model, state_dict, global_step)``: the config's model with the
    checkpoint's weights."""
    dev = get_device(device)
    model = build_from_file(config_path, dev)
    state, step = _load_state(checkpoint_path, dev)
    model.load_state_dict(state)
    info(f'[Load params] from {checkpoint_path}')
    return model, model.state_dict(), step


def build_from_model_dir(model_dir: str, checkpoint_name: Optional[str] = None,
                         device: Device = None):
    """``(model, state_dict, step)`` from a training run's ``model_dir``:
    its ``config.pkl`` (or ``config.py``) and the checkpoint
    ``checkpoint_name``, or the one chosen as the module docstring says."""
    dev = get_device(device)
    cfg_path = next((p for p in (os.path.join(model_dir, 'config.pkl'),
                                 os.path.join(model_dir, 'config.py'))
                     if os.path.exists(p)), None)
    if cfg_path is None:
        raise FileNotFoundError('The config file is not found in model_dir.')
    if checkpoint_name is None:
        best = os.path.join(model_dir, 'model-best.ckpt')
        if os.path.exists(best):
            model, state, _ = build_and_load_from_file(cfg_path, best, dev)
            return model, state, 'best'
        info_fp = os.path.join(model_dir, ckpt_lib.CHECKPOINT_NAME)
        if os.path.exists(info_fp):
            with open(info_fp) as f:
                name = (json.load(f).get(ckpt_lib.LASTCHECKPOINT) or {}).get('name')
            if name and os.path.exists(os.path.join(model_dir, name)):
                checkpoint_name = name
        if checkpoint_name is None:
            steps = {p.name: int(p.name[len('checkpoint-'):-len('.ckpt')])
                     for p in Path(model_dir).glob('checkpoint-*.ckpt')
                     if p.name[len('checkpoint-'):-len('.ckpt')].isdigit()}
            if not steps:
                raise FileNotFoundError(f'no checkpoints in {model_dir}')
            checkpoint_name = max(steps, key=steps.get)
    return build_and_load_from_file(cfg_path, os.path.join(model_dir, checkpoint_name), dev)


def export_model(*args, **kwargs):
    """Not ported: a serialised program needs the attention kernels (K1,
    K2) registered as ``torch.library`` ops for ``torch.export``."""
    raise NotImplementedError('export_model needs K1/K2 as torch.library ops for '
                              'torch.export (ROADMAP.md A.5, export_model)')
