"""EfficientNet-B0 at 72² in the port against the JAX package, on the CPU:
a size that 32 does not divide, where the stem and the strided depthwise
convs pad as lax's ``'SAME'`` (the odd pixel after), at output stride 32,
16 and 8 (``test_torch_efficientnet.py`` holds the rest at 64²).

At output stride 32 in float64 as there: the five taps (36, 18, 9, 5 and
3 wide), the statistics and every gradient, tolerance ``TRUNK``.  At 16
and 8 (the first block of a stage whose stride is removed keeps the
previous dilation, the later ones double it; the taps are still taken
before each former stride-2 stage) a train-mode forward from the same
seeded weights, drop-connect off on both sides: the five taps, every
BatchNorm's running statistics, and the dilation and stride of each
depthwise conv.  These in float32: XLA's CPU convolutions take tens of
seconds for a dilated depthwise conv in float64.  Tolerance 1e-4 of the
scale: flax takes the batch variance in one pass (E[x²] − E[x]²),
PyTorch in two, and the trunk's activations are SiLUs, so no mask flips
on a rounding.
"""

import numpy as np
import pytest
import torch

from test_torch_efficientnet import (_port_encoder, compare, jax_train_grads, jeff,  # noqa: F401
                                     no_drop_connect, convert_flax_efficientnet,
                                     test_b0_taps_statistics_and_gradients_match_jax as _b0)
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _x

pytestmark = pytest.mark.usefixtures('one_torch_thread')

F32_TRAIN = 1e-4


@pytest.mark.usefixtures('no_drop_connect')
def test_b0_at_72_matches_jax():
    """B0's taps, statistics and gradients at 72², as at 64²."""
    _b0(72)

@pytest.mark.usefixtures('no_drop_connect')
@pytest.mark.parametrize('output_stride', [16, 8])
def test_output_stride_surgery_matches_jax(output_stride):
    """Output stride 16 and 8 at 72²: the first block of each stage whose
    stride is removed keeps the previous dilation, the later ones double
    it; the taps (still taken before each former stride-2 stage) and the
    running statistics of a train forward."""
    x = _x((2, 72, 72, 3), seed=7).astype(np.float32)
    cfg = dict(efficientnet_type='efficientnet-b0', output_stride=output_stride)
    ref = jax_train_grads(jeff.EFNetEncoder(cfg), x, grads=False, x64=False)
    tm = _port_encoder(cfg, ref['v'], torch.float32)
    with torch.no_grad():
        outs = tm(torch.from_numpy(x), train=True)
    side = 72 // output_stride + (72 % output_stride > 0)
    assert outs[-1].shape[2:] == (side, side) and outs[-2].shape[2:] == (
        (side, side) if output_stride == 8 else (5, 5))
    compare(tm, ref, convert_flax_efficientnet, outs, [], F32_TRAIN)
    dil = [b._depthwise_conv.dilation[0] for b in tm.net._blocks]
    strides = [b._depthwise_conv.stride[0] for b in tm.net._blocks]
    want = {16: ([1] * 11 + [1, 2, 2, 2, 2], [1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1] + [1] * 5),
            8: ([1] * 6 + [2] * 6 + [4] * 4,
                [1, 2, 1, 2, 1] + [1] * 11)}[output_stride]
    assert (dil, strides) == want
