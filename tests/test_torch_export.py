"""``infer_tool.export_model`` and the kernels as ``torch.library`` ops, on
the CPU.

Every kernel of the port is an op of the ``ever_tpu_torch`` namespace with
a fake implementation and, where the TPU kernel had a gradient, a
registered autograd formula; ``torch.library.opcheck`` checks each on CPU
tensors (schema, fake tensors, autograd registration, AOT dispatch).  Then
the slice as a whole: a narrow FarSeg (ResNet-18 trunk, head width 16) and
a 2-block DinoSeg (width 64, ``attn_impl='fused'``, so its attention is the
op ``attention_fwd`` on its plain version) are saved through a checkpoint
from the JAX package's seeded weights, exported in floating point and
with ``ptq_calib``, loaded back with ``torch.export.load(...).module()``
and run: the programs equal the eager model and the eager W8A8 model bit
for bit, and agree with the JAX model's ``apply`` (1e-4, float32 sums in
other orders) and the JAX ``ptq_apply`` (``test_torch_ptq._close``: the
two packages' int8 roundings differ where their float32 activations lie
at a bin boundary).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.library import opcheck

import ever_tpu_torch  # noqa: F401  (registers the ops)
from ever_tpu.core import builder as jbuilder
from ever_tpu.module import vit as jvit
from ever_tpu.ops import ptq as jptq
from ever_tpu_torch.api import infer_tool as tinfer
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.ops import attention as A, norm as N, pool as P, ptq as tptq, quant as Q
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg, convert_flax_farseg
from test_torch_ptq import _close
from test_torch_resnet import close, one_torch_thread, seeded_variables  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TINY = ('vit_tiny_test', (2, 64, 2, 4.0, 'mlp'))
SHAPE = (2, 64, 64, 3)


def _rand(*shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)
                            .astype(np.float32)).to(dtype)


def _int8(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, shape)
                            .astype(np.int8))


def _attention_args(layout='bnhd', rope=False, n_valid=None, grad=False):
    shape = (2, 40, 2, 64) if layout == 'bnhd' else (2, 2, 40, 64)
    q, k, v = (_rand(*shape, seed=i).requires_grad_(grad) for i in range(3))
    sin, cos = (_rand(40, 64, seed=5), _rand(40, 64, seed=6)) if rope else (None, None)
    return (q, k, v, sin, cos, layout, n_valid)


def _attention_bwd_args():
    q, k, v, sin, cos, layout, n_valid = _attention_args(rope=True, n_valid=37)
    o, lse = A.fused_attention(q, k, v, layout, n_valid, (sin, cos))
    return (q, k, v, o, lse, _rand(*o.shape, seed=7), sin, cos, layout, n_valid)


def _ln_bwd_args():
    x, w = _rand(37, 96, seed=1), _rand(96, seed=2)
    _, mean, rstd = N.layer_norm_fwd(x, w, _rand(96, seed=3), 1e-6)
    return (x, _rand(37, 96, seed=4), w, mean, rstd)


def _pool_bwd_args():
    x = _rand(2, 8, 6, 3, seed=1)
    out = P.max_pool_32(x)
    return (x, out, _rand(*out.shape, seed=2))


OPS = {
    'attention_fwd': (A._attention_fwd_op, lambda: _attention_args()),
    'attention_fwd-bhnd': (A._attention_fwd_op, lambda: _attention_args('bhnd')),
    'attention_fwd-rope-grad': (A._attention_fwd_op,
                                lambda: _attention_args(rope=True, n_valid=37, grad=True)),
    'attention_bwd': (A._attention_bwd_op, _attention_bwd_args),
    'layer_norm_fwd': (N._layer_norm_fwd_op,
                       lambda: (_rand(37, 96, seed=1), _rand(96, seed=2), _rand(96, seed=3), 1e-6)),
    'layer_norm_fwd-grad': (N._layer_norm_fwd_op,
                            lambda: (_rand(37, 96, seed=1).requires_grad_(),
                                     _rand(96, seed=2).requires_grad_(),
                                     _rand(96, seed=3).requires_grad_(), 1e-6)),
    'layer_norm_bwd': (N._layer_norm_bwd_op, _ln_bwd_args),
    'max_pool_32': (P._max_pool_32_op, lambda: (_rand(2, 8, 6, 3, seed=1),)),
    'max_pool_32-grad': (P._max_pool_32_op,
                         lambda: (_rand(2, 8, 6, 3, seed=1).requires_grad_(),)),
    'max_pool_32_bwd': (P._max_pool_32_bwd_op, _pool_bwd_args),
    'quantize_int8_values': (Q._quantize_op,
                             lambda: (_rand(16, 32), torch.full((1, 1), 0.02), 3, True)),
    'quantize_int8_values-nearest': (Q._quantize_op,
                                     lambda: (_rand(16, 32), torch.full((1, 1), 0.02), 3, False)),
    'int8_matmul_t': (Q._int8_matmul_op,
                      lambda: (_int8(5, 48), torch.ones(1, 1), _int8(7, 48, seed=1),
                               torch.full((1, 1), 0.5))),
}


@pytest.mark.parametrize('case', sorted(OPS))
def test_every_op_passes_opcheck(case):
    op, args = OPS[case]
    opcheck(op, args())


def test_every_kernel_launch_is_a_registered_op_with_cpu_cuda_and_fake_kernels():
    names = {'attention_fwd', 'attention_bwd', 'layer_norm_fwd', 'layer_norm_bwd',
             'max_pool_32_bwd', 'quantize_int8_values', 'int8_matmul_t'}
    for name in names:
        qual = f'ever_tpu_torch::{name}'
        for key in ('CPU', 'CUDA', 'Meta'):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), (qual, key)


# -- the exported programs ------------------------------------------------------------

NARROW = dict(
    encoder=dict(resnet_type='resnet18', maxpool_impl='pallas'),
    head=dict(fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=16),
              fs_relation=dict(scene_embedding_channels=512,
                               in_channels_list=(16,) * 4, out_channels=16),
              fpn_decoder=dict(in_channels=16, out_channels=16)),
    classes=3, dtype='float32')


@pytest.fixture(scope='module')
def tiny_vit():
    jvit.VIT_SPECS[TINY[0]] = tvit.VIT_SPECS[TINY[0]] = TINY[1]
    yield
    del jvit.VIT_SPECS[TINY[0]], tvit.VIT_SPECS[TINY[0]]


def _model(kind):
    """(JAX model, its seeded variables, the port's config params, the
    port's state_dict of those variables)."""
    x = np.zeros(SHAPE, np.float32)
    if kind == 'farseg':
        jm = jbuilder.make_model({'type': 'FarSeg', 'params': NARROW})
        v = seeded_variables(jm, x, seed=4)
        return jm, v, ('FarSeg', NARROW), convert_flax_farseg(v)
    params = dict(backbone=dict(name=TINY[0], attn_impl='xla'), classes=3, dtype='float32')
    jm = jbuilder.make_model({'type': 'DinoSeg', 'params': params})
    v = seeded_variables(jm, x, seed=5)
    tparams = dict(params, backbone=dict(name=TINY[0], attn_impl='fused'))
    return jm, v, ('DinoSeg', tparams), convert_flax_dinoseg(v['params'])


@pytest.mark.parametrize('kind', ['farseg', 'dinoseg'])
def test_exported_programs_match_eager_and_jax(tmp_path, tiny_vit, kind):
    jm, v, (typ, params), sd = _model(kind)
    cfg = tmp_path / 'config.py'
    cfg.write_text(f'config = dict(model=dict(type={typ!r}, params={params!r}))\n')
    ckpt = tmp_path / 'checkpoint-1.ckpt'
    torch.save(sd, ckpt)
    rng = np.random.default_rng(11)
    calib = [rng.normal(size=SHAPE).astype(np.float32)]
    x = rng.normal(size=SHAPE).astype(np.float32)
    xt = torch.from_numpy(x)

    fp_path, q_path = str(tmp_path / 'model.pt2'), str(tmp_path / 'model_int8.pt2')
    tinfer.export_model(str(cfg), str(ckpt), SHAPE, fp_path, device='cpu')
    tinfer.export_model(str(cfg), str(ckpt), SHAPE, q_path, ptq_calib=calib, device='cpu')
    assert os.path.getsize(fp_path) > 0 and os.path.getsize(q_path) > 0
    fp_prog = torch.export.load(fp_path).module()
    q_prog = torch.export.load(q_path).module()
    targets = {str(n.target) for n in torch.export.load(q_path).graph.nodes}
    assert 'ever_tpu_torch.int8_matmul_t.default' in targets
    if kind == 'dinoseg':
        assert 'ever_tpu_torch.attention_fwd.default' in targets

    model, state, _ = tinfer.build_and_load_from_file(str(cfg), str(ckpt), device='cpu')
    qv = tptq.ptq_quantize(model, state, [torch.from_numpy(calib[0])],
                           apply_kwargs=dict(train=False), min_in_features=64)
    with torch.no_grad():
        eager = model(xt, train=False)
        eager_q = tptq.ptq_apply(model, qv, xt, train=False)
        got, got_q = fp_prog(xt), q_prog(xt)
    assert torch.equal(got, eager) and torch.equal(got_q, eager_q)

    want = np.asarray(jax.jit(lambda t: jm.apply(v, t, train=False))(jnp.asarray(x)))
    close(got.numpy(), want, 1e-4)
    jqv = jptq.ptq_quantize(jm, v, [jnp.asarray(calib[0])], apply_kwargs=dict(train=False),
                            min_in_features=64)
    want_q = np.asarray(jax.jit(jptq.make_ptq_predict_fn(jm, jqv, train=False))(jnp.asarray(x)))
    _close(got_q.numpy(), want_q, want)
    n_jax = len(jax.tree_util.tree_leaves(jqv['ptq'])) // 3
    assert len(qv['ptq']) == n_jax

