"""Build a trained model for inference (counterpart of
``ever_tpu/api/infer_tool.py``): from a config file, from a config and a
checkpoint, or from a training run's model dir.

Each builder returns the JAX package's triple ``(model, variables, step)``:
``model`` holds the checkpoint's weights, is in eval mode and sits on
``device`` (the GPU unless ``device='cpu'``); ``variables`` is its
``state_dict``.  A model dir's checkpoint is ``model-best.ckpt`` when there
is one (``step`` is then ``'best'``), else the one ``checkpoint_info.json``
names as ``last``, else the highest ``checkpoint-N.ckpt``.
:func:`export_model` writes the eval forward, in floating point or int8
W8A8, as a ``torch.export`` program.
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


class _EvalForward(torch.nn.Module):
    """The model's eval forward as a one-argument module for
    ``torch.export``: ``model(x, train=False)``, with the layers named in
    ``ptq`` (``{name: (kernel_q, 1 / x_scale, x_scale · w_scale)}``) in int8
    on K7.  The int8 tensors are this module's buffers, so the exported
    program holds them."""

    def __init__(self, model: torch.nn.Module, ptq: Optional[dict] = None):
        super().__init__()
        self.model = model
        self.names = sorted(ptq or {})
        for i, name in enumerate(self.names):
            for part, t in zip(('kernel_q', 'inv', 'scale'), ptq[name]):
                self.register_buffer(f'ptq{i}_{part}', t)

    def forward(self, x):
        if not self.names:
            return self.model(x, train=False)
        from ever_tpu_torch.ops.ptq import _Serving
        table = {name: tuple(getattr(self, f'ptq{i}_{part}')
                             for part in ('kernel_q', 'inv', 'scale'))
                 for i, name in enumerate(self.names)}
        with _Serving(self.model, table):
            return self.model(x, train=False)


def export_model(config_path: str, checkpoint_path: str, input_shape,
                 output_path: str, ptq_calib=None, ptq_act_percentile=None,
                 ptq_except_re=None, device: Device = None):
    """Trace the eval forward at a float32 ``input_shape`` with
    ``torch.export`` and write the program to ``output_path``
    (``torch.export.save``; the JAX package serialises a ``jax.export``).

    ``ptq_calib``: optional iterable of calibration batches; when given,
    the program serves int8 W8A8 (``ever_tpu_torch.ops.ptq``, with
    ``min_in_features=64`` in eval mode, as the JAX package calibrates):
    the quantized weights and the int8 layers, K7 among the program's ops,
    are in the file.  ``ptq_act_percentile`` selects percentile calibration;
    ``ptq_except_re`` keeps the layers whose dotted names it matches in
    floating point.  The kernels are ``torch.library`` ops, so the program
    calls K1 (and K7) on the card and their plain versions on the CPU.

    Load it with ``torch.export.load(output_path).module()`` after ``import
    ever_tpu_torch`` (which registers the ops); the program takes the
    ``[N, H, W, C]`` float32 batch of ``input_shape`` on ``device`` (the GPU
    unless ``device='cpu'``).  Returns the ``ExportedProgram``.
    """
    dev = get_device(device)
    model, variables, _ = build_and_load_from_file(config_path, checkpoint_path, dev)
    ptq = None
    if ptq_calib is not None:
        from ever_tpu_torch.ops.ptq import _prepare, ptq_quantize
        qv = ptq_quantize(model, variables, ptq_calib, apply_kwargs=dict(train=False),
                          min_in_features=64, act_percentile=ptq_act_percentile,
                          except_re=ptq_except_re)
        ptq = {name: _prepare(entry) for name, entry in qv['ptq'].items()}
    x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=dev)
    with torch.no_grad():
        exported = torch.export.export(_EvalForward(model, ptq).eval(), (x,), strict=False)
    torch.export.save(exported, output_path)
    info(f'[export model] to {output_path}')
    return exported
