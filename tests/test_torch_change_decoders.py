"""ChangeMask in the port against the JAX package, on the CPU: its eval
outputs in float32 (within 1e-5) and its losses and one SGD step in
float64, with and without the consistency loss (ChangeOS:
``tests/test_torch_changeos.py``).  The geometry, seeds and tolerances are
``tests/test_torch_change.py``'s.
"""

import jax
import numpy as np
import torch

from ever_tpu_torch.util.weight_io import convert_flax_change
from test_torch_change import TRUNK, eval_matches, pairs
from test_torch_factseg import both, one_step_matches, small_cpu_models  # noqa: F401

MASK = dict(TRUNK, classes=3, loss=dict(ignore_index=255, consistency_weight=0.1))


def test_changemask_eval_matches_jax():
    """Eval mode, float32: ChangeMask's (softmax(s1), softmax(s2), σ(c))."""
    x, _ = pairs()
    got = eval_matches('ChangeMask', MASK, x)
    np.testing.assert_allclose(got[1].sum(-1).numpy(), 1.0, atol=1e-5)


def test_changemask_one_step_matches_jax():
    """ChangeMask with ``consistency_weight`` 0.1: sem_loss, change_loss and
    consistency_loss, then one SGD step; with the weight 0 the port gives
    the same sem and change losses and no consistency loss."""
    x, y = pairs()
    labels = dict(masks=y['classes'], change=y['change'])
    with jax.enable_x64(True):
        jm, tm, v = both('ChangeMask', MASK, x, convert_flax_change, dtype='float64')
        met = one_step_matches(jm, tm, v, (x, labels), convert_flax_change,
                               ['sem_loss', 'change_loss', 'consistency_loss'])
        zero = dict(MASK, loss=dict(ignore_index=255, consistency_weight=0.0))
        _, tm0, _ = both('ChangeMask', zero, x, convert_flax_change, dtype='float64')
    assert float(met['consistency_loss']) > 0
    with torch.no_grad():
        got0 = tm0(torch.from_numpy(x), jax.tree.map(torch.from_numpy, labels), train=True)
    assert set(got0) == {'sem_loss', 'change_loss'}
    for k in got0:
        np.testing.assert_allclose(float(got0[k]), float(met[k]), rtol=1e-6, err_msg=k)

