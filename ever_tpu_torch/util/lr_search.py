"""The LR range test's hook (counterpart of ``ever_tpu/util/lr_search.py``).

:class:`PlotLearningRateAndLoss` pairs with the ``search`` LR schedule
(``opt/learning_rate.py``, an exponential sweep): registered on the
launcher's logger (``logger.register_train_log_hook``), it records each
logged step's learning rate and loss, and at the end of training writes
them as a CSV (always) and plots loss against LR on a log axis when
matplotlib imports (it is imported here, and is optional).
"""

from __future__ import annotations

import csv

from ever_tpu_torch.core.logger import TrainLogHook

__all__ = ['PlotLearningRateAndLoss']


class PlotLearningRateAndLoss(TrainLogHook):
    """Records ``(lr, loss)`` per logged step; ``after_train`` writes
    ``save_path`` (``.csv`` added unless it ends so) and, with matplotlib,
    the plot (``save_path`` if it ends in ``.png``/``.pdf``, else
    ``save_path + '.png'``).  The loss is ``total_loss``, else the sum of
    the ``*loss`` entries."""

    def __init__(self, save_path: str):
        self.losses = []
        self.lrs = []
        self.save_path = save_path

    def after_iter(self, global_step, loss_dict, learning_rate):
        self.losses.append(float(loss_dict.get('total_loss',
                                               sum(v for k, v in loss_dict.items()
                                                   if k.endswith('loss')))))
        self.lrs.append(float(learning_rate))

    def after_train(self):
        csv_path = (self.save_path if self.save_path.endswith('.csv')
                    else self.save_path + '.csv')
        with open(csv_path, 'w', newline='') as f:
            w = csv.writer(f)
            w.writerow(['lr', 'loss'])
            w.writerows(zip(self.lrs, self.losses))
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except ImportError:
            return
        plt.plot(self.lrs, self.losses)
        plt.xscale('log')
        plt.xlabel('learning rate')
        plt.ylabel('loss')
        fig_path = (self.save_path if self.save_path.endswith(('.png', '.pdf'))
                    else self.save_path + '.png')
        plt.savefig(fig_path)
        plt.close()
