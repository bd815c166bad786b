"""ChangeOS in the port against the JAX package, on the CPU: its eval
outputs in float32 (within 1e-5) and its losses and one SGD step in
float64.  The geometry, seeds and tolerances are
``tests/test_torch_change.py``'s.
"""

import jax
import numpy as np

from ever_tpu_torch.util.weight_io import convert_flax_change
from test_torch_change import TRUNK, eval_matches, pairs
from test_torch_factseg import both, one_step_matches, small_cpu_models  # noqa: F401

OS = dict(TRUNK, damage_classes=4)


def test_changeos_eval_matches_jax():
    """Eval mode, float32: ChangeOS's (σ(loc), softmax(damage))."""
    x, _ = pairs()
    got = eval_matches('ChangeOS', OS, x)
    np.testing.assert_allclose(got[1].sum(-1).numpy(), 1.0, atol=1e-5)


def test_changeos_one_step_matches_jax():
    """ChangeOS: loc_loss (BCE) and damage_loss (CE), then one SGD step."""
    x, y = pairs()
    with jax.enable_x64(True):
        jm, tm, v = both('ChangeOS', OS, x, convert_flax_change, dtype='float64')
        one_step_matches(jm, tm, v, (x, dict(loc=y['loc'], damage=y['damage'])),
                         convert_flax_change, ['loc_loss', 'damage_loss'])
