"""Project scaffolding: ``python -m ever_tpu_torch create <path>``
(counterpart of ``ever_tpu/util/_main.py``).

A project gets ``train.py`` and ``infer.py`` (the JAX package's scripts with
``ever_tpu_torch`` for ``ever_tpu``), empty ``module/`` and ``data/``
directories that the scripts register, and the configs of the repository's
``project_template/configs/`` (plain dicts that both packages read) when the
package sits in a checkout of the repository.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Optional

__all__ = ['TRAIN_SCRIPT', 'INFER_SCRIPT', 'create_project']

_REGISTER_SNIPPET = '''\
import os

import ever_tpu_torch as er
from ever_tpu_torch.core import registry

# auto-register this project's models/datasets so `@registry.MODEL.register`
# classes in module/ and data/ are importable by config `type` name
_HERE = os.path.dirname(os.path.abspath(__file__))
for _d in ('module', 'data'):
    _p = os.path.join(_HERE, _d)
    if os.path.isdir(_p):
        registry.register_dir(_p, recursive=True)
'''

TRAIN_SCRIPT = _REGISTER_SNIPPET + '''\


def train(trainer_name=None):
    # None defers to the --trainer CLI flag (default th_ddp); passing a name
    # here would silently override it
    trainer = er.trainer.get_trainer(trainer_name)()
    trainer.run()


if __name__ == '__main__':
    train()
'''

INFER_SCRIPT = _REGISTER_SNIPPET + '''\


def main(model_dir):
    model, variables, step = er.infer_tool.build_from_model_dir(model_dir)
    # boxes = er.sliding_window((H, W), 512, 512)
    # probs = er.tiled_inference(model, scene, 512, 512, classes)


if __name__ == '__main__':
    import sys
    main(sys.argv[1])
'''


def _configs_dir() -> Optional[str]:
    """``project_template/configs`` of the checkout holding the package, or
    None when the package is installed without it."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cand = os.path.join(repo, 'project_template', 'configs')
    return cand if os.path.isdir(cand) else None


def create_project(path: str) -> None:
    """Scaffold a project at ``path`` (existing files of the same names are
    overwritten)."""
    for d in ('configs', 'module', 'data'):
        os.makedirs(os.path.join(path, d), exist_ok=True)
    with open(os.path.join(path, 'train.py'), 'w') as f:
        f.write(TRAIN_SCRIPT)
    with open(os.path.join(path, 'infer.py'), 'w') as f:
        f.write(INFER_SCRIPT)
    configs = _configs_dir()
    for cfg in sorted(glob.glob(os.path.join(configs, '*.py'))) if configs else ():
        shutil.copy(cfg, os.path.join(path, 'configs'))
    print(f'created project in {path}')
