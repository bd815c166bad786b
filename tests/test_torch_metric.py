"""The port's metric package against ``ever_tpu.metric`` on the CPU.

The stream of ``docs/parity/METRIC_PARITY.md`` (6 batches of 2×64×64,
scattered 255, one all-ignored batch, one absent class, one class that
appears only in the predictions) through both ``PixelMetric``s: the
confusion matrix exactly, the tables, their getters and CSV to 1e-6; the
metric functions; ``ScoreTracker``; a cell counted past 2²⁴; and the
evaluation closures run by a stub launcher on both sides.
"""

import csv
import logging
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.data.loader import DataLoader as JDataLoader
from ever_tpu.metric import evaluate_fn as jeval
from ever_tpu.metric import function as jfn
from ever_tpu.metric.pixel import PixelMetric as JPixelMetric
from ever_tpu.metric.utils import ScoreTracker as JScoreTracker
from ever_tpu_torch.metric import evaluate_fn as teval
from ever_tpu_torch.metric import function as tfn
from ever_tpu_torch.metric.confusion_matrix import ConfusionMatrix
from ever_tpu_torch.metric.pixel import PixelMetric as TPixelMetric
from ever_tpu_torch.metric.utils import ScoreTracker as TScoreTracker

NUM_CLASSES = 7
TOL = 1e-6


def make_streams(num_classes=NUM_CLASSES, batches=6, seed=0):
    """``tools/metric_parity.py``'s stream: truth in [0, C-2), predictions in
    [0, C-1) (70 % correct), 10 % ignored pixels, batch 2 all ignored."""
    rng = np.random.default_rng(seed)
    streams = []
    for b in range(batches):
        y_true = rng.integers(0, num_classes - 2, size=(2, 64, 64)).astype(np.int64)
        y_pred = np.where(rng.random((2, 64, 64)) < 0.7, y_true,
                          rng.integers(0, num_classes - 1, size=(2, 64, 64))).astype(np.int64)
        y_true = np.where(rng.random((2, 64, 64)) < 0.1, 255, y_true)
        if b == 2:
            y_true = np.full_like(y_true, 255)
        streams.append((y_true, y_pred))
    return streams


def _cells(tb):
    return [c for row in tb.rows for c in row]


def _assert_tables_close(got, want, tol=TOL):
    assert got.field_names == want.field_names
    assert len(got.rows) == len(want.rows)
    for g, w in zip(_cells(got), _cells(want)):
        if isinstance(w, str):
            assert g == w
        else:
            assert abs(float(g) - float(w)) <= tol, (g, w)


def _csv_rows(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


@pytest.fixture(scope='module')
def pixel_metrics():
    jpm, tpm = JPixelMetric(NUM_CLASSES), TPixelMetric(NUM_CLASSES)
    for y_true, y_pred in make_streams():
        want = np.asarray(jpm.forward(y_true, y_pred))
        got = tpm.forward(torch.from_numpy(y_true), torch.from_numpy(y_pred))
        np.testing.assert_array_equal(got, want)
    return jpm, tpm


def test_stream_confusion_matrix_is_exact(pixel_metrics):
    jpm, tpm = pixel_metrics
    assert tpm.dense_cm.dtype == np.float64
    np.testing.assert_array_equal(tpm.dense_cm, jpm.dense_cm)
    assert tpm.dense_cm[NUM_CLASSES - 1].sum() == tpm.dense_cm[:, NUM_CLASSES - 1].sum() == 0
    assert tpm.dense_cm[NUM_CLASSES - 2].sum() == 0 < tpm.dense_cm[:, NUM_CLASSES - 2].sum()


@pytest.mark.parametrize('summary', ['summary_all', 'summary_iou'])
def test_stream_tables_getters_and_csv_match_jax(pixel_metrics, summary, tmp_path):
    jpm, tpm = pixel_metrics
    want, got = getattr(jpm, summary)(), getattr(tpm, summary)()
    _assert_tables_close(got, want)
    if summary == 'summary_all':
        for g in ('iou', 'f1', 'precision', 'recall'):
            np.testing.assert_allclose(getattr(got, g)(list(range(NUM_CLASSES))),
                                       getattr(want, g)(list(range(NUM_CLASSES))),
                                       rtol=0, atol=TOL)
            assert getattr(got, g)(3) == pytest.approx(getattr(want, g)(3), abs=TOL)
    want.to_csv(tmp_path / 'jax.csv')
    got.to_csv(tmp_path / 'port.csv')
    rows_w, rows_g = _csv_rows(tmp_path / 'jax.csv'), _csv_rows(tmp_path / 'port.csv')
    assert len(rows_g) == len(rows_w)
    for rg, rw in zip(rows_g, rows_w):
        for g, w in zip(rg, rw, strict=True):
            try:
                assert abs(float(g) - float(w)) <= TOL
            except ValueError:
                assert g == w


def test_summary_with_class_names_and_cm_dump(tmp_path):
    names = [f'c{i}' for i in range(NUM_CLASSES)]
    log = logging.getLogger('test_torch_metric')
    jpm = JPixelMetric(NUM_CLASSES, str(tmp_path / 'jax'), logger=log, class_names=names)
    tpm = TPixelMetric(NUM_CLASSES, str(tmp_path / 'port'), logger=log, class_names=names)
    for y_true, y_pred in make_streams(seed=1):
        jpm.forward(y_true, y_pred)
        tpm.forward(y_true, y_pred)
    _assert_tables_close(tpm.summary_all(), jpm.summary_all())
    dumps = list((tmp_path / 'port' / 'cm').glob('confusion_matrix-*.npy'))
    assert len(dumps) == 1
    np.testing.assert_array_equal(np.load(dumps[0]), jpm.dense_cm)
    with pytest.raises(ValueError, match='class_names'):
        TPixelMetric(3, class_names=['a'])


def test_metric_functions_match_jax():
    """The confusion matrix (ignore-aware, predictions clipped) exactly; OA,
    AA, kappa, IoU and mIoU in float32 to 1e-6; ``th_confusion_matrix``
    (every in-range pixel, class count from the labels) exactly."""
    y_true, y_pred = make_streams(seed=3)[0]
    y_pred = y_pred.copy()
    y_pred[0, 0, :4] = [-2, 9, 255, 6]
    want = jfn.confusion_matrix(jnp.asarray(y_true), jnp.asarray(y_pred), NUM_CLASSES)
    got = tfn.confusion_matrix(torch.from_numpy(y_true), torch.from_numpy(y_pred), NUM_CLASSES)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ('overall_accuracy_score', 'average_accuracy_score',
                 'cohen_kappa_score', 'iou_per_class', 'mean_iou'):
        np.testing.assert_allclose(getattr(tfn, name)(got).numpy(),
                                   np.asarray(getattr(jfn, name)(want)),
                                   rtol=0, atol=TOL, err_msg=name)
    _, accs = tfn.average_accuracy_score(got, return_accuracys=True)
    np.testing.assert_allclose(accs.numpy(), np.asarray(
        jfn.average_accuracy_score(want, return_accuracys=True)[1]), atol=TOL)
    t, p = np.array([0, 1, 2, 2, 4]), np.array([0, 2, 2, 1, 3])
    np.testing.assert_array_equal(tfn.th_confusion_matrix(t, p).numpy(),
                                  np.asarray(jfn.th_confusion_matrix(t, p)))


def test_scores_with_class_axis_take_the_first_maximum():
    """Scores ``[..., C]`` are reduced by argmax, ties to the first class."""
    scores = np.zeros((1, 2, 2, 3), np.float32)
    scores[0, 0, 0] = [0.5, 0.5, 0.1]                   # tie: class 0
    scores[0, 1, 1] = [0.1, 0.7, 0.7]                   # tie: class 1
    y = np.array([[[0, 0], [0, 1]]])
    cm = ConfusionMatrix(3).forward(y, torch.from_numpy(scores))
    np.testing.assert_array_equal(cm, np.asarray(JPixelMetric(3).forward(y, scores)))
    assert cm[1, 1] == 1 and cm[0, 0] == 3


def test_a_cell_past_two_to_the_24_stays_exact():
    """2²⁴ + 3 pixels of class 0 predicted 0 (uint8), and one ignored and
    one class-1 pixel: float32 counting would stop at 2²⁴."""
    n = 2 ** 24 + 3
    y_true = np.zeros(n + 2, np.uint8)
    y_pred = np.zeros(n + 2, np.uint8)
    y_true[-2], y_true[-1], y_pred[-1] = 255, 1, 1
    cm = ConfusionMatrix(2)
    got = cm.forward(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    assert got[0, 0] == n and got[1, 1] == 1 and got.sum() == n + 1
    cm.forward(y_true[:5], y_pred[:5])
    assert cm.dense_cm[0, 0] == n + 5


def test_score_tracker_matches_jax(tmp_path):
    """Ragged score dicts (a key added later, a key missing once), best and
    worst lookups and the CSV."""
    evals = [({'miou': 0.3, 'oa': 0.7}, 10), ({'miou': 0.5}, 20),
             ({'miou': 0.4, 'oa': 0.8, 'kappa': 0.6}, 30)]
    j, t = JScoreTracker(), TScoreTracker()
    assert t.highest_score('miou') == j.highest_score('miou')
    for scores, step in evals:
        j.append(scores, step)
        t.append(scores, step)
    assert t.scores == j.scores and len(t) == len(j) == 3
    for name in ('miou', 'oa', 'kappa'):
        assert t.highest_score(name) == j.highest_score(name)
        assert t.lowest_score(name) == j.lowest_score(name)
    j.to_csv(str(tmp_path / 'j.csv'))
    t.to_csv(str(tmp_path / 't.csv'))
    assert (tmp_path / 't.csv').read_text() == (tmp_path / 'j.csv').read_text()


# -- the evaluation closures with a stub launcher on both sides ---------------------

def _logit_stream(seed=5, n=7, classes=NUM_CLASSES):
    """Per-sample (logits [16, 16, C], labels [16, 16]) with 255 pixels."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        logits = rng.normal(size=(16, 16, classes)).astype(np.float32)
        y = rng.integers(0, classes, size=(16, 16)).astype(np.int32)
        y[rng.random((16, 16)) < 0.1] = 255
        items.append((logits, y))
    return items


def _outputs(task, side, x):
    """The stub model: the inputs are logits; the change model returns
    (s1, s2, change probability), the damage model (localization
    probability, damage logits)."""
    if task in ('pixel', 'distributed_pixel'):
        return x
    sig = (lambda t: 1 / (1 + jnp.exp(-t))) if side == 'jax' else torch.sigmoid
    if task == 'change':
        return x, x, sig(x[..., :1])
    return sig(x[..., :1]), x[..., 1:]


def _stub(tmp_path, side, task, n_dev):
    """The launcher surface the closures use; the eval step records the
    batch sizes it was given."""
    seen = []

    def eval_step(state, batch):
        seen.append(int(batch[0].shape[0]))
        return _outputs(task, side, batch[0])

    if side == 'jax':
        mesh = None if n_dev == 1 else types.SimpleNamespace(shape={'data': n_dev})
    else:
        mesh = None if n_dev == 1 else types.SimpleNamespace(size=lambda: n_dev)
    stub = types.SimpleNamespace(model_dir=str(tmp_path / side), state=None, mesh=mesh,
                                 logger=logging.getLogger('test_torch_metric'),
                                 checkpoint=None, info=lambda msg: None,
                                 get_eval_step=lambda local=False: eval_step)
    return stub, seen


class _Items:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize('n_dev', [1, 4])
@pytest.mark.parametrize('task', ['pixel', 'distributed_pixel', 'change', 'damage'])
def test_evaluation_closures_match_jax(tmp_path, task, n_dev):
    """7 samples in batches of 3 (a tail of 1) through each closure: the
    table to 1e-6.  With a 4-way mesh on the stub the JAX package pads every
    batch to 4 before its step (one program over the mesh's devices) and
    drops the padding after it; the port's eval step is rank-local, one
    card a process, and gets the batches as they are."""
    from ever_tpu_torch.interface.dataloader import default_collate
    items = _logit_stream()
    if task == 'change':
        items = [(lg[..., :1], {'change': np.where(y == 255, 255, y % 2).astype(np.int32)})
                 for lg, y in items]
    if task == 'damage':
        items = [(lg[..., :6], {'damage': np.where(y == 255, 255, y % 5).astype(np.int32)})
                 for lg, y in items]
    make = {'pixel': lambda m: m.evaluate_pixel_prediction_task(NUM_CLASSES),
            'distributed_pixel': lambda m: m.distributed_evaluate_pixel_prediction_task(
                NUM_CLASSES),
            'change': lambda m: m.evaluate_change_detection_task(),
            'damage': lambda m: m.evaluate_damage_assessment_task()}[task]
    tables = {}
    for side, mod in (('jax', jeval), ('port', teval)):
        stub, seen = _stub(tmp_path, side, task, n_dev)
        if side == 'jax':
            loader = JDataLoader(_Items(items), batch_size=3)
        else:
            loader = torch.utils.data.DataLoader(_Items(items), batch_size=3,
                                                 collate_fn=default_collate)
        tables[side] = make(mod)(stub, loader)
        assert seen == ([3, 3, 1] if n_dev == 1 or side == 'port' else [4, 4, 4]), (side, seen)
    _assert_tables_close(tables['port'], tables['jax'])
