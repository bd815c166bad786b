"""`ERModule` — the configurable model base class (``torch.nn.Module`` edition).

Counterpart of ``ever_tpu/interface/module.py`` and
``ever_tpu/interface/configurable.py``: a module owns an :class:`AttrDict`
``config`` built from the class defaults (``set_default_config``) merged
recursively with the user's dict, so user configs only name deltas.  The
forward contract is ``forward(x, y=None, train=False)``: a loss dict when
training with labels, predictions otherwise.

The pretrained workflow is the JAX package's (the reference's hub mixin):
:meth:`ERModule.save_pretrained` writes ``config.json`` (``{'type',
'params'}``, the same file the JAX package writes for the same config)
and the ``state_dict`` as ``pytorch_model.bin``; :meth:`ERModule.
from_pretrained` rebuilds the model from them; :meth:`ERModule.push_to_hub`
uploads that directory through ``huggingface_hub`` when it imports.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ever_tpu_torch.core.config import AttrDict

__all__ = ['ERModule', 'sum_losses', 'split_metrics', 'GLOBAL_KEY']

# the reserved top-level config key of run-global options (the weight path)
GLOBAL_KEY = 'GLOBAL'
# the weights file of a save_pretrained directory
WEIGHTS_NAME = 'pytorch_model.bin'


class ERModule(nn.Module):
    """Configurable ``nn.Module``: ``config`` = defaults ⊕ user config.

    ::

        @MODEL.register()
        class MySeg(ERModule):
            def set_default_config(self):
                self.config.update(dict(classes=7, channels=256))

        m = MySeg(dict(classes=5))   # config.classes == 5, channels == 256
    """

    def __init__(self, config: Optional[dict] = None):
        super().__init__()
        self.config = AttrDict()
        self.set_default_config()
        if config:
            self.config.update(config)

    def set_default_config(self) -> None:
        """Populate ``self.config`` with class defaults (override me)."""

    @property
    def global_config(self) -> AttrDict:
        """The reserved ``GLOBAL`` sub-config (weight path etc.)."""
        return self.config.get(GLOBAL_KEY, AttrDict())

    def log_info(self) -> Dict[str, Any]:
        """Extra static info to log at startup."""
        return {}

    def forward(self, x, y=None, train: bool = False):
        raise NotImplementedError

    def custom_param_groups(self, params=None):
        """Optional optimizer groups: ``(labels, {label: lr_mult})``, with
        ``labels`` a ``{dotted name prefix: label}`` dict or a ``name ->
        label`` callable (``opt/optimizer.py`` ``UpdateRule``); ``None`` (the
        default) for one group."""
        return None

    # -- the pretrained workflow ---------------------------------------------
    def save_pretrained(self, save_directory: str,
                        variables: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Write ``config.json`` (``{'type': registry name, 'params':
        config}``) and ``variables`` (the model's ``state_dict`` unless
        given) as ``pytorch_model.bin`` to a directory.  The class must be
        registered in ``MODEL``, under its own name, to be rebuilt."""
        from ever_tpu_torch.core.registry import MODEL

        name = type(self).__name__
        if name not in MODEL:
            raise ValueError(f'{name} is not registered in MODEL — save_pretrained needs a '
                             'registry name to rebuild')
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, 'config.json'), 'w') as f:
            json.dump({'type': name, 'params': _jsonable(self.config)}, f, indent=2)
        state = self.state_dict() if variables is None else variables
        torch.save({k: v.detach().cpu() for k, v in state.items()},
                   os.path.join(save_directory, WEIGHTS_NAME))

    def push_to_hub(self, repo_id: str, variables: Optional[Dict[str, torch.Tensor]] = None,
                    save_directory: Optional[str] = None, *, private: bool = False,
                    token: Optional[str] = None, commit_message: Optional[str] = None,
                    create_repo: bool = True):
        """Upload a :meth:`save_pretrained` directory to a Hugging Face Hub
        repo through ``huggingface_hub.HfApi.upload_folder``: written fresh
        from ``variables`` (the model's own ``state_dict`` when neither
        ``variables`` nor ``save_directory`` is given), or
        ``save_directory`` pushed as it is.  Without ``huggingface_hub`` it raises with the
        offline recipe, as the JAX package does."""
        try:
            from huggingface_hub import HfApi
        except ImportError as e:
            raise RuntimeError(
                'push_to_hub needs the huggingface_hub package; offline '
                'recipe: save_pretrained(dir, variables) then upload the '
                'directory with `huggingface_hub.upload_folder` (or the web '
                'UI) once networked') from e
        if variables is not None and save_directory is not None:
            raise ValueError('pass at most one of variables= (serialize fresh) or '
                             'save_directory= (push as-is)')

        def push(folder: str):
            api = HfApi(token=token)
            if create_repo:
                api.create_repo(repo_id, private=private, exist_ok=True)
            return api.upload_folder(
                repo_id=repo_id, folder_path=folder,
                commit_message=commit_message or f'upload {type(self).__name__} (ever_tpu_torch)')

        if save_directory is not None:
            if not os.path.exists(os.path.join(save_directory, 'config.json')):
                raise ValueError(f'{save_directory!r} is not a save_pretrained directory '
                                 '(no config.json)')
            return push(save_directory)
        with tempfile.TemporaryDirectory() as td:
            self.save_pretrained(td, variables)
            return push(td)

    @classmethod
    def from_pretrained(cls, save_directory: str, device=None):
        """``(model, state_dict)`` from a :meth:`save_pretrained` directory:
        the model built from ``config.json`` through ``builder.make_model``
        on ``device`` (the GPU unless ``device='cpu'``), its weights loaded
        strictly."""
        from ever_tpu_torch.core import builder

        with open(os.path.join(save_directory, 'config.json')) as f:
            spec = json.load(f)
        model = builder.make_model(spec, device=device)
        state = torch.load(os.path.join(save_directory, WEIGHTS_NAME), map_location='cpu',
                           weights_only=True)
        model.load_state_dict(state, strict=True)
        return model, model.state_dict()


def _jsonable(obj):
    """A config as plain JSON types (tuples → lists, AttrDicts → dicts)."""
    if isinstance(obj, dict) or hasattr(obj, 'items'):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def sum_losses(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum every ``*loss`` entry of a forward output dict into the objective,
    in float32.  Other keys are metrics and are left out.  The sum stays on
    the losses' device: a host-made zero copied there would make the host
    wait for the card in every step."""
    losses = [v.float() for k, v in loss_dict.items() if k.endswith('loss')]
    if not losses:
        return torch.zeros(())
    total = losses[0]
    for v in losses[1:]:
        total = total + v
    return total


def split_metrics(loss_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """All entries (losses and metrics) as detached float32 scalars."""
    return {k: torch.as_tensor(v).detach().float() for k, v in loss_dict.items()}
