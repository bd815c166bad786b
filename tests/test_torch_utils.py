"""The utilities and compatibility paths of the port (the rest of
``ROADMAP.md`` A.8) against the JAX package, on the CPU.

``pad_crop_apply`` and ``PadCropWrapper`` (a prefix-free ``state_dict``
and a dict output cropped leaf by leaf), the ``magic.bigimage`` paths,
``PlotLearningRateAndLoss`` (the CSV and the plot from the same logged
steps, and a run of the port's ``Launcher`` under the ``search``
schedule), ``count_model_params_flops`` and ``prettytable_to_dataframe`` /
``prettytable_to_csv``.  The same numpy inputs go to both packages.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.magic import bigimage as jbigimage
from ever_tpu.magic.bigimage.sliding_window import sliding_window as jdeep_sliding_window
from ever_tpu.magic.tiled import pad_crop_apply as jpad_crop_apply
from ever_tpu.metric.pixel import AccTable as JAccTable
from ever_tpu.metric.pixel import prettytable_to_csv as jtable_csv
from ever_tpu.metric.pixel import prettytable_to_dataframe as jtable_df
from ever_tpu.util.lr_search import PlotLearningRateAndLoss as JPlot
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core.launcher import Launcher
from ever_tpu_torch.magic import bigimage, pad_crop_apply
from ever_tpu_torch.magic.bigimage.sliding_window import sliding_window as deep_sliding_window
from ever_tpu_torch.metric.pixel import AccTable, prettytable_to_csv, prettytable_to_dataframe
from ever_tpu_torch.module import PadCropWrapper
from ever_tpu_torch.util.lr_search import PlotLearningRateAndLoss
from ever_tpu_torch.util.param_util import count_model_params_flops
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _avg3(x):
    """A 3x3 box sum over NHWC with zero padding: every output pixel reads
    its neighbours, so the zero pad shows at the crop's edge."""
    xc = x.permute(0, 3, 1, 2)
    w = torch.ones(xc.shape[1], 1, 3, 3, dtype=x.dtype)
    return torch.nn.functional.conv2d(xc, w, padding=1, groups=xc.shape[1]).permute(0, 2, 3, 1)


def _javg3(x):
    import jax
    w = jnp.ones((3, 3, 1, x.shape[-1]), x.dtype)
    return jax.lax.conv_general_dilated(x, w, (1, 1), ((1, 1), (1, 1)),
                                        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
                                        feature_group_count=x.shape[-1])


@pytest.mark.parametrize('size', [(37, 45), (32, 64), (1, 33)])
def test_pad_crop_apply_matches_jax(size):
    x = np.random.default_rng(0).normal(size=(2, *size, 3)).astype(np.float32)
    want = jpad_crop_apply(lambda t: {'y': _javg3(t), 'mask': t[..., 0] > 0},
                           jnp.asarray(x), 32)
    got = pad_crop_apply(lambda t: {'y': _avg3(t), 'mask': t[..., 0] > 0},
                         torch.from_numpy(x), 32)
    assert got['y'].shape == (2, *size, 3) and got['mask'].shape == (2, *size)
    np.testing.assert_allclose(got['y'].numpy(), np.asarray(want['y']), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got['mask'].numpy(), np.asarray(want['mask']))


class _Inner(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 4)
        self.register_buffer('count', torch.zeros(()))

    def forward(self, x, scale=1.0):
        return self.proj(_avg3(x)) * scale


def test_pad_crop_wrapper_state_dict_has_no_prefix_and_output_is_cropped():
    torch.manual_seed(0)
    inner = _Inner()
    wrapped = PadCropWrapper(_Inner(), size_divisor=32)
    assert list(wrapped.state_dict()) == list(inner.state_dict())
    wrapped.load_state_dict(inner.state_dict(), strict=True)
    assert all(torch.equal(a, b) for a, b in zip(wrapped.inner.parameters(), inner.parameters()))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 37, 45, 3)).astype(np.float32))
    with torch.no_grad():
        got = wrapped(x, scale=2.0)
        padded = torch.nn.functional.pad(x, (0, 0, 0, 64 - 45, 0, 64 - 37))
        want = inner(padded, scale=2.0)[:, :37, :45]
    assert torch.equal(got, want)
    # nested: the wrapper's own prefix stays, the inner one goes
    outer = torch.nn.Sequential(PadCropWrapper(_Inner()))
    assert set(outer.state_dict()) == {'0.count', '0.proj.weight', '0.proj.bias'}
    outer.load_state_dict(outer.state_dict(), strict=True)


@pytest.mark.parametrize('size,k,s', [((200, 150), 64, 48), ((4096, 4096), 512, 384)])
def test_bigimage_paths_match_jax(size, k, s):
    """``magic.bigimage.sliding_window`` is the tiling function, as in the
    JAX package (importing the submodule of the same name rebinds the
    package attribute to it, in both packages)."""
    assert bigimage.__all__ == jbigimage.__all__ == ['sliding_window']
    np.testing.assert_array_equal(deep_sliding_window(size, k, s),
                                  jdeep_sliding_window(size, k, s))


def _steps():
    return [(i + 1, {'cls_loss': 2.0 - 0.1 * i, 'aux_loss': 0.5}, 1e-5 * 1.5 ** i)
            for i in range(5)] + [(6, {'total_loss': 1.25, 'cls_loss': 1.0}, 1e-5 * 1.5 ** 5)]


@pytest.mark.parametrize('suffix', ['lrs', 'lrs.csv', 'lrs.png'])
def test_lr_search_hook_writes_the_jax_csv_and_plot(tmp_path, suffix):
    for cls, d in ((JPlot, tmp_path / 'jax'), (PlotLearningRateAndLoss, tmp_path / 'port')):
        d.mkdir()
        hook = cls(str(d / suffix))
        for step, losses, lr in _steps():
            hook.after_iter(step, losses, lr)
        hook.after_train()
    files = sorted(p.name for p in (tmp_path / 'jax').iterdir())
    assert files == sorted(p.name for p in (tmp_path / 'port').iterdir())
    csv = [f for f in files if f.endswith('.csv')][0]
    assert (tmp_path / 'port' / csv).read_text() == (tmp_path / 'jax' / csv).read_text()
    rows = (tmp_path / 'port' / csv).read_text().splitlines()
    assert rows[0] == 'lr,loss' and len(rows) == 7 and rows[-1].endswith(',1.25')
    assert any(f.endswith('.png') for f in files)


def test_lr_search_hook_records_a_launcher_run_under_the_search_schedule(tmp_path):
    """Six steps of a linear model through the port's ``Launcher`` with the
    ``search`` schedule: one CSV row a step, each LR the schedule's value at
    that step, finite losses."""
    torch.manual_seed(0)

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 2)

        def forward(self, x, y=None, train=False, generator=None):
            logits = self.lin(x).mean((1, 2))
            if train:
                return {'cls_loss': torch.nn.functional.cross_entropy(logits, y[:, 0, 0].long())}
            return logits

    sched = tbuilder.make_learningrate({'type': 'search', 'params': dict(
        init_lr=1e-5, final_lr=1.0, max_iters=6)})
    factory, _ = tbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    launcher = Launcher(str(tmp_path), Tiny(), factory.build(sched), sched, device='cpu')
    hook = PlotLearningRateAndLoss(str(tmp_path / 'lrs'))
    launcher.logger.register_train_log_hook(hook)
    rng = np.random.default_rng(2)
    data = [(rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
             rng.integers(0, 2, (4, 8, 8)).astype(np.int64)) for _ in range(6)]
    launcher.train_iters(data, num_iters=6, log_interval_step=1)
    rows = [r.split(',') for r in (tmp_path / 'lrs.csv').read_text().splitlines()[1:]]
    assert len(rows) == 6
    lrs = [float(r[0]) for r in rows]
    np.testing.assert_allclose(lrs, [sched.value_at(s) for s in range(6)], rtol=1e-6)
    assert all(np.isfinite(float(r[1])) for r in rows)


def test_count_model_params_flops_logs_both(caplog):
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    log = logging.getLogger('test_torch_utils.count')
    with caplog.at_level(logging.INFO, logger='test_torch_utils.count'):
        assert count_model_params_flops(model, model, torch.zeros(5, 8),
                                        _default_logger=log) is None
    text = caplog.text
    assert '#params: 212, 0.0 M' in text
    assert f'# FLOPs: {2 * 5 * (8 * 16 + 16 * 4)}, 0.0 G' in text


def _tables():
    rows = [['0', 0.5, 0.25, 0.75], ['1', 0.125, 1.0, 0.0625]]
    out = []
    for cls in (JAccTable, AccTable):
        tb = cls(['name', 'iou', 'f1', 'precision'])
        for r in rows:
            tb.add_row(r)
        out.append(tb)
    return out


def test_prettytable_to_dataframe_and_csv_match_jax(tmp_path):
    jtb, tb = _tables()
    df, want = prettytable_to_dataframe(tb), jtable_df(jtb)
    assert list(df.columns) == list(want.columns) and df.equals(want)
    prettytable_to_csv(tb, str(tmp_path / 'port.csv'))
    jtable_csv(jtb, str(tmp_path / 'jax.csv'))
    assert (tmp_path / 'port.csv').read_text() == (tmp_path / 'jax.csv').read_text()
