"""HRNetV2-W18 at full depth (1 + 4 + 3 modules, four blocks a branch) in
the port against the JAX package, on the CPU: one train-mode forward at
64², B=2, in float64 from the same seeded weights gives the four features
and every BatchNorm's running statistics after it.  Tolerance 1e-9 of the
scale: both sides are float64 throughout and the fuse sums its terms in
the same order.  The gradients are held on the cut trunk in
``test_torch_hrnet.py``: the full trunk's JAX gradient costs about a
minute on a CPU.  The JAX forward runs op by op: compiling the whole
trunk under ``jax.jit`` took 54 s on a loaded CPU against 22 s op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu_torch.util.weight_io import convert_flax_hrnet
from test_torch_hrnet import TOL, W18, _port
from test_torch_resnet import close, one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _nhwc, _seeded, _x

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def full():
    """The JAX W18's train-mode features and new statistics (op by op),
    and the port's W18 after the same forward."""
    x = _x((2, 64, 64, 3))
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': 'HRNetEncoder', 'params': dict(W18, dtype='float64')})
        v = _seeded(jm, jnp.asarray(x))
        feats, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=['batch_stats'])
    tm = _port(W18, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True)
    return [np.asarray(f) for f in feats], mut['batch_stats'], tm, got


def test_full_w18_features_match_jax(full):
    """The four features of the full trunk (18, 36, 72, 144 wide)."""
    want, _, _, got = full
    assert [tuple(f.shape) for f in got] == [(2, 18, 16, 16), (2, 36, 8, 8),
                                             (2, 72, 4, 4), (2, 144, 2, 2)]
    for g, w in zip(got, want):
        close(_nhwc(g), w, TOL)


def test_full_w18_running_statistics_match_jax(full):
    """The running statistics of all 305 BatchNorms (610 buffers) after
    the train forward."""
    _, stats, tm, _ = full
    moved = convert_flax_hrnet({}, stats)
    assert len(moved) == 610
    sd = tm.state_dict()
    for k, w in moved.items():
        close(sd[k].numpy(), w.numpy(), TOL)
