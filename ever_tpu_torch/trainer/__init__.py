"""Trainer registry and command line (counterpart of
``ever_tpu/trainer/__init__.py``).

``get_trainer(name, argv)`` parses the command line and returns a zero-arg
factory of the trainer.  ``base`` trains in one process; ``th_ddp`` and
``spmd`` are :class:`SPMDTrainer`, data parallel over the processes
``torchrun`` starts (one card each), and the same as ``base`` in one plain
process.  ``gan_th_ddp`` and ``gan_spmd`` are :class:`~ever_tpu_torch.
trainer.gan.GANSPMDTrainer`, the same over a GAN's two optimizers
(``trainer/gan.py``).  ``--device`` picks the card
(``cuda``, the default: the process's own under torchrun) or ``cpu``
(gloo).
"""

from __future__ import annotations

import argparse

from ever_tpu_torch.trainer.trainer import SPMDTrainer, Trainer, half_bn, merge_dict  # noqa: F401

# the reference's class spelling: the data-parallel trainer
THDDPTrainer = SPMDTrainer

__all__ = ['get_trainer', 'parse_args', 'get_default_parser', 'TRAINER',
           'Trainer', 'SPMDTrainer', 'THDDPTrainer', 'THDDPGANTrainer', 'merge_dict',
           'half_bn']


def _gan_trainer(args):
    from ever_tpu_torch.trainer.gan import GANSPMDTrainer
    return GANSPMDTrainer(args)


def THDDPGANTrainer(args):
    """The reference's spelling of the GAN trainer."""
    return _gan_trainer(args)


TRAINER = {
    'base': Trainer,
    'th_ddp': SPMDTrainer,
    'spmd': SPMDTrainer,
    'gan_th_ddp': _gan_trainer,
    'gan_spmd': _gan_trainer,
}


def get_default_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='ever_tpu_torch training launcher')
    parser.add_argument('--config_path', required=True, type=str,
                        help='config file path or dotted name under configs/')
    parser.add_argument('--model_dir', required=True, type=str)
    parser.add_argument('--trainer', default='th_ddp', type=str,
                        choices=sorted(TRAINER))
    parser.add_argument('--mixed_precision', default='fp32', type=str,
                        choices=['fp32', 'fp16', 'bf16'],
                        help='fp16 maps to bf16 (no loss scaling)')
    parser.add_argument('--device', default='cuda', type=str,
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--use_wandb', action='store_true')
    parser.add_argument('--use_tensorboard', action='store_true')
    parser.add_argument('--project', default=None, type=str)
    parser.add_argument('--entity', default=None, type=str)
    parser.add_argument('--local_rank', default=0, type=int,
                        help='accepted for the reference command line; torchrun '
                             'sets LOCAL_RANK')
    parser.add_argument('--find_unused_parameters', action='store_true',
                        help='passed to DistributedDataParallel')
    parser.add_argument('opts', nargs=argparse.REMAINDER,
                        help='dotted-key overrides: k v [k v ...]')
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    args = get_default_parser().parse_args(argv)
    if args.mixed_precision == 'fp16':
        args.mixed_precision = 'bf16'
    return args


def get_trainer(name: str = None, argv=None):
    """A zero-arg factory of the trainer ``name`` (else ``--trainer``)."""
    args = parse_args(argv)
    key = name or args.trainer
    if key not in TRAINER:
        raise KeyError(f'unknown trainer {key!r}; available: {sorted(TRAINER)}')
    return lambda: TRAINER[key](args)
