"""``ever.module.dinov3.utils.utils`` in the port: the reference's helpers
over the module tree (the JAX package walks its parameter dicts instead,
having no mutable modules)."""

from __future__ import annotations

import os
import random
import subprocess
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ever_tpu_torch.module.ops import BatchNorm2d
from ever_tpu_torch.module.vit import cat_keep_shapes, uncat_with_shapes

__all__ = ['cat_keep_shapes', 'uncat_with_shapes', 'named_replace', 'named_apply',
           'fix_random_seeds', 'get_sha', 'get_conda_env', 'count_parameters',
           'has_batchnorms']


def named_replace(fn: Callable, module: nn.Module, name: str = '', depth_first: bool = True,
                  include_root: bool = False) -> nn.Module:
    """Rebuild a module tree: ``fn(module=m, name=dotted)`` on every module
    returns its replacement, set in its parent's place (children first when
    ``depth_first``)."""
    if not depth_first and include_root:
        module = fn(module=module, name=name)
    for child_name, child in list(module.named_children()):
        full = f'{name}.{child_name}' if name else child_name
        setattr(module, child_name, named_replace(fn, child, full, depth_first, True))
    if depth_first and include_root:
        module = fn(module=module, name=name)
    return module


def named_apply(fn: Callable, module: nn.Module, name: str = '', depth_first: bool = True,
                include_root: bool = False) -> nn.Module:
    """``fn(module=m, name=dotted)`` on every module of the tree (children
    first when ``depth_first``), e.g. ``named_apply(init_weights_vit, m)``."""
    if not depth_first and include_root:
        fn(module=module, name=name)
    for child_name, child in module.named_children():
        named_apply(fn, child, f'{name}.{child_name}' if name else child_name, depth_first, True)
    if depth_first and include_root:
        fn(module=module, name=name)
    return module


def fix_random_seeds(seed: int = 31) -> None:
    """Seed Python's, numpy's and torch's generators (every device's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_sha() -> str:
    """The git commit, its state and branch of this file's checkout."""
    cwd = os.path.dirname(os.path.abspath(__file__))

    def _run(cmd):
        return subprocess.check_output(cmd, cwd=cwd).decode('ascii').strip()

    sha, diff, branch = 'N/A', 'clean', 'N/A'
    try:
        sha = _run(['git', 'rev-parse', 'HEAD'])
        subprocess.check_output(['git', 'diff'], cwd=cwd)
        diff = _run(['git', 'diff-index', 'HEAD'])
        diff = 'has uncommitted changes' if diff else 'clean'
        branch = _run(['git', 'rev-parse', '--abbrev-ref', 'HEAD'])
    except Exception:
        pass
    return f'sha: {sha}, status: {diff}, branch: {branch}'


def get_conda_env() -> Tuple[Optional[str], Optional[str]]:
    return (os.environ.get('CONDA_DEFAULT_ENV'), os.environ.get('CONDA_PREFIX'))


def count_parameters(module: nn.Module) -> int:
    """The number of trainable parameter elements."""
    return sum(p.numel() for p in module.parameters() if p.requires_grad)


def has_batchnorms(module: nn.Module) -> bool:
    """Whether the tree holds a BatchNorm (torch's or the port's)."""
    kinds = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d, nn.SyncBatchNorm, BatchNorm2d)
    return any(isinstance(m, kinds) for m in module.modules())
