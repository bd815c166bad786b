"""Score tracking across evaluations (counterpart of
``ever_tpu/metric/utils.py``, without its wandb sink)."""

from __future__ import annotations

import csv

from ever_tpu_torch.core.dist import main_process_only

__all__ = ['ScoreTracker']


class ScoreTracker:
    def __init__(self):
        self._data = {'step': []}

    def append(self, scores: dict, step) -> None:
        # columns must stay rectangular even when score dicts differ across
        # evals (a ragged column misaligns highest_score's row lookup and
        # crashes to_csv): backfill new keys, forward-fill absent ones
        n_before = len(self._data['step'])
        self._data['step'].append(step)
        for k, v in scores.items():
            col = self._data.setdefault(k, [None] * n_before)
            col.append(v)
        for k, col in self._data.items():
            if len(col) <= n_before:
                col.append(None)

    @property
    def scores(self) -> dict:
        return self._data

    @main_process_only
    def to_csv(self, path: str) -> None:
        keys = list(self._data)
        with open(path, 'w', newline='') as f:
            w = csv.writer(f)
            w.writerow(keys)
            for i in range(len(self)):
                w.writerow([self._data[k][i] for k in keys])

    def _arg_best(self, name: str, best) -> int:
        valid = [(v, i) for i, v in enumerate(self._data[name])
                 if v is not None]
        return best(valid)[1]

    def highest_score(self, name: str) -> dict:
        if len(self) == 0 or not any(
                v is not None for v in self._data.get(name, [])):
            return {'step': -1, name: float('-inf')}
        idx = self._arg_best(name, max)
        return {k: v[idx] for k, v in self._data.items()}

    def lowest_score(self, name: str) -> dict:
        if len(self) == 0 or not any(
                v is not None for v in self._data.get(name, [])):
            return {'step': -1, name: float('inf')}
        idx = self._arg_best(name, min)
        return {k: v[idx] for k, v in self._data.items()}

    def __len__(self) -> int:
        return len(self._data['step'])
