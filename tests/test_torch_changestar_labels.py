"""ChangeStar's label forms in the port against the JAX package, on the
CPU: a 3-D mask, masks without ``change``, the tuple forms and
``symmetry`` off, as train-mode losses in float64 (rtol 1e-6).  The
geometry, seeds and tolerances are ``tests/test_torch_change.py``'s.
"""

import jax
import numpy as np
import torch

from ever_tpu_torch.util.weight_io import convert_flax_change
from test_torch_change import STAR, pairs, train_losses
from test_torch_factseg import both, small_cpu_models  # noqa: F401


def test_changestar_label_forms_match_jax():
    """The other label forms, train-mode losses in float64 (rtol 1e-6): a
    3-D mask (one date: no seg loss of s2) and dict masks without
    ``change`` (derived from ``m1 != m2`` where both are valid) against
    the JAX model; the tuples ``(m1, m2, change)`` and ``(m1, change)``,
    which the JAX model reads as those dicts, give the dicts' losses."""
    x, y = pairs()
    m = y['masks']
    forms = [dict(masks=m[..., 0], change=y['change']), dict(masks=m)]
    with jax.enable_x64(True):
        jm, tm, v = both('ChangeStar', STAR, x, convert_flax_change, dtype='float64')
        got, want = train_losses(jm, tm, v, x, forms)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {'seg_loss', 'change_loss'}, i
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-6, err_msg=f'{i} {k}')
    tuples, dicts = [(m[..., 0], m[..., 1], y['change']), (m[..., 0], y['change'])], [
        dict(masks=m, change=y['change']), forms[0]]
    for t, d in zip(tuples, dicts):
        with torch.no_grad():
            a = tm(torch.from_numpy(x), jax.tree.map(torch.from_numpy, t), train=True)
            b = tm(torch.from_numpy(x), jax.tree.map(torch.from_numpy, d), train=True)
        assert set(a) == set(b) and all(float(a[k]) == float(b[k]) for k in a)


def test_changestar_without_symmetry_matches_jax():
    """``loss.symmetry=False``: the change loss of c12 alone (float64, rtol
    1e-6)."""
    x, y = pairs()
    cfg = dict(STAR, loss=dict(ignore_index=255, symmetry=False))
    with jax.enable_x64(True):
        jm, tm, v = both('ChangeStar', cfg, x, convert_flax_change, dtype='float64')
        (g,), (w,) = train_losses(jm, tm, v, x, [dict(masks=y['masks'], change=y['change'])])
    for k in ('seg_loss', 'change_loss'):
        np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-6, err_msg=k)
