"""A 50-step training trajectory of FarSeg-R50 in the port against the JAX
step, on the CPU (the trajectory check of ``docs/parity/TRAJECTORY.md``,
with the JAX package standing in for the reference).

FarSeg on ResNet-50's bottlenecks and widths cut in depth to one block a
stage (``resnet50_d1``, registered in both packages' ``RESNET_SPECS``
while the module runs) with its FPN, relation and decoder at 64 channels
(``HEAD``): at the default depth and 256/128-channel head the JAX
package's float64 step on the CPU made this the longest file of the
suite (its head alone 1.16 s of a forward, 0.27 s at 64).  7 classes, at
32², global batch 4, float64
(parameters and compute; the JAX side under ``jax.enable_x64``), SGD with
momentum 0.9 and weight decay, a poly schedule, a global norm clip of 35 and
``ignore_index=255``, from the same seeded weights (carried over by
``convert_flax_farseg``) and the same seeded batches.  The geometry is 32²,
not 64²: the JAX package's float64 step on the CPU took the file past its
budget at 64²; the step count stays 50.

At batch 4 the trajectory is chaotic: both packages keep the loss, FarSeg's
relation map, decoder resizes and scene pooling in float32, and a
difference in the last float32 bit grows from step to step through
BatchNorm over a few values a channel, so two coupled runs separate far
beyond 1e-6 within a few steps even where each step agrees to float32
rounding (the 2-rank test below prints both).  So each of the 50 steps is
held from the same state: along the JAX run's 50
coupled steps, the port loads the JAX state (parameters, running
statistics, momentum) and takes its own step on the same batch.  Its loss
must agree within 1e-6 relative, its new parameters and running statistics
within 1e-6 of each tensor's scale, and its gradient norm within 1e-5
relative (the gradients pass through float32 sums that each package adds
in its own order), on every step.

Then 10 steps of the port over 2 gloo ranks (2 samples a rank), where rank
0 also takes the one-process step from each step's state on the whole
batch: every step, the two agree as closely; the 2-rank losses equal the
JAX losses within 1e-6 on the steps before the separation (the first two)
and the largest difference over the 10 coupled steps is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import dist
from ever_tpu_torch.parallel import spmd as tspmd
from ever_tpu_torch.parallel.mesh import make_mesh
from ever_tpu_torch.util.weight_io import convert_flax_farseg
from test_torch_dist import start_ranks
from test_torch_resnet import seeded_variables, torch_threads

STEPS, RANK_STEPS, BEFORE_SEPARATION = 50, 10, 2
BATCH, SIZE, CLASSES = 4, 32, 7
TRUNK = 'resnet50_d1'
HEAD = dict(fpn=dict(out_channels=64),
            fs_relation=dict(in_channels_list=(64,) * 4, out_channels=64),
            fpn_decoder=dict(in_channels=64, out_channels=64))
CFG = dict(encoder=dict(resnet_type=TRUNK), head=HEAD, classes=CLASSES,
           loss=dict(ignore_index=255, ce=dict(), dice=None), dtype='float64')
REL_TOL = 1e-6
# the gradient norm: the gradients reach the trunk through float32 sums
# (the relation map's over 256 channels, the loss's over the pixels) that
# each package adds in its own order
NORM_REL_TOL = 1e-5


def _register_trunk():
    """``TRUNK`` (ResNet-50's bottlenecks and widths, one block a stage) in
    both packages; returns the modules it was added to."""
    from ever_tpu.module import resnet as jresnet
    from ever_tpu_torch.module import resnet as tresnet
    added = []
    for mod in (jresnet, tresnet):
        if TRUNK not in mod.RESNET_SPECS:
            mod.RESNET_SPECS[TRUNK] = (mod.Bottleneck, (1, 1, 1, 1)) + tuple(
                mod.RESNET_SPECS['resnet50'][2:])
            added.append(mod)
    return added


def _batches():
    """50 seeded batches: normal images, labels in [0, 7) with a corner
    and a random 5 % of the pixels ignored."""
    rng = np.random.default_rng(2026)
    x = rng.normal(size=(STEPS, BATCH, SIZE, SIZE, 3))
    y = rng.integers(0, CLASSES, size=(STEPS, BATCH, SIZE, SIZE)).astype(np.int32)
    y[:, :, :4, :4] = 255
    y[rng.random(y.shape) < 0.05] = 255
    return x, y


def _sgd(builder):
    sched = builder.make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.01, power=0.9, max_iters=STEPS)})
    factory, _ = builder.make_optimizer({'type': 'sgd', 'params': dict(
        momentum=0.9, weight_decay=1e-4)})
    return sched, factory.build(sched, grad_clip=dict(max_norm=35.0))


def _port(state_dict, mesh=None):
    """The port's float64 FarSeg from ``state_dict``, its train state and
    step."""
    model = tbuilder.make_model({'type': 'FarSeg', 'params': CFG}, device='cpu').double()
    model.load_state_dict(state_dict, strict=True)
    sched, rule = _sgd(tbuilder)
    state = tspmd.create_train_state(model, rule)
    return model, state, tspmd.build_train_step(model, rule, sched, mesh=mesh)


def _set_state(model, state, step, state_dict, momentum):
    """Load parameters, running statistics and SGD momentum (None before
    the first step) into the port, at ``step``."""
    model.load_state_dict(state_dict, strict=True)
    if momentum is not None:
        for name, p in model.named_parameters():
            state.optimizer.state[p]['momentum_buffer'] = momentum[name].clone()
    state.step = step


def _max_rel(got: dict, want: dict) -> float:
    """Largest max |got - want| / max(1, max |want|) over the tensors."""
    return max(float((got[k].double() - w.double()).abs().max()) / max(1.0, float(w.abs().max()))
               for k, w in want.items() if w.is_floating_point())


def _trace(opt_state):
    """The momentum trace in an optax state."""
    if isinstance(opt_state, optax.TraceState):
        return opt_state.trace
    for s in opt_state if isinstance(opt_state, (tuple, list)) else ():
        t = _trace(s)
        if t is not None:
            return t
    return None


def _rank_worker(rank, world, init, tmp):
    """One rank of the 2-rank run: its half of each of the first 10
    batches.  Rank 0 also takes the one-process step from each step's
    state and writes both runs' metrics and their largest state
    difference."""
    torch.set_num_threads(1)
    _register_trunk()
    dist.init_dist_env(init, world, rank, backend='gloo')
    x, y = _batches()
    n = BATCH // world
    init_sd = torch.load(f'{tmp}/init.pt', weights_only=True)
    model, state, step = _port(init_sd, mesh=make_mesh())
    if rank == 0:
        ref_model, ref_state, ref_step = _port(init_sd)
    rows = []
    for t in range(RANK_STEPS):
        if rank == 0:
            momentum = None if t == 0 else {
                name: state.optimizer.state[p]['momentum_buffer']
                for name, p in model.named_parameters()}
            _set_state(ref_model, ref_state, t, model.state_dict(), momentum)
            ref_state, ref = ref_step(ref_state, (torch.from_numpy(x[t]), torch.from_numpy(y[t])))
        state, met = step(state, (torch.from_numpy(x[t, rank * n:(rank + 1) * n]),
                                  torch.from_numpy(y[t, rank * n:(rank + 1) * n])))
        if rank == 0:
            rows.append([float(met['cls_loss']), float(ref['cls_loss']), float(met['grad_norm']),
                         float(ref['grad_norm']),
                         _max_rel(model.state_dict(), ref_model.state_dict())])
    if rank == 0:
        np.save(f'{tmp}/ranks.npy', np.asarray(rows))


@pytest.fixture(scope='module')
def trunk():
    added = _register_trunk()
    yield
    for mod in added:
        del mod.RESNET_SPECS[TRUNK]


@pytest.fixture(scope='module')
def trajectory(tmp_path_factory, trunk):
    """The JAX run's 50 coupled steps, and beside each the port's step from
    the same state: rows of (JAX loss, port loss, JAX grad norm, port grad
    norm, largest state difference); the 2-rank job runs meanwhile."""
    tmp = tmp_path_factory.mktemp('trajectory')
    x, y = _batches()
    # one intra-op thread, as the port's other files take it (a default
    # pool contends with the other test workers)
    with jax.enable_x64(True), torch_threads(1):
        jm = jbuilder.make_model({'type': 'FarSeg', 'params': CFG})
        v = jax.tree.map(lambda a: np.asarray(a, np.float64), seeded_variables(jm, x[0]))
        torch.save(convert_flax_farseg(v), tmp / 'init.pt')
        ranks = start_ranks('test_torch_trajectory', '_rank_worker', 2, tmp, tmp)
        sched, tx = _sgd(jbuilder)
        jstate = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                                  batch_stats=v['batch_stats'], opt_state=tx.init(v['params']))
        jstep = jspmd.build_train_step(jm, tx, sched, donate=False)
        model, state, step = _port(convert_flax_farseg(v))
        rows = []
        # the JAX state before each step, converted once (it is also the
        # state after the step before)
        jax_sd, momentum = convert_flax_farseg(v['params'], v['batch_stats']), None
        for t in range(STEPS):
            _set_state(model, state, t, jax_sd, momentum)
            batch = (x[t], y[t])
            state, met = step(state, tuple(map(torch.from_numpy, batch)))
            jstate, jmet = jstep(jstate, tuple(map(jnp.asarray, batch)))
            host = jax.device_get(jstate)
            jax_sd = convert_flax_farseg(host.params, host.batch_stats)
            momentum = convert_flax_farseg(_trace(host.opt_state))
            rows.append([float(jmet['cls_loss']), float(met['cls_loss']),
                         float(jmet['grad_norm']), float(met['grad_norm']),
                         _max_rel(model.state_dict(), jax_sd)])
    ranks.finish(timeout=600)
    return np.asarray(rows), np.load(tmp / 'ranks.npy')


def _rel(got, want):
    return np.abs(got - want) / np.abs(want)


def test_each_of_fifty_steps_matches_the_jax_step(trajectory):
    rows, _ = trajectory
    loss, norm, state = _rel(rows[:, 1], rows[:, 0]), _rel(rows[:, 3], rows[:, 2]), rows[:, 4]
    print(f'FarSeg-{TRUNK} {SIZE}², {STEPS} steps of the JAX run, the port stepping from each '
          f'state: largest relative difference of the loss {loss.max():.3e} (step '
          f'{loss.argmax() + 1}), of the gradient norm {norm.max():.3e}, of the new state '
          f'{state.max():.3e}; JAX loss {rows[0, 0]:.6f} -> {rows[-1, 0]:.6f}')
    assert rows[-5:, 0].mean() < rows[:5, 0].mean()              # the run trains
    assert loss.max() <= REL_TOL and state.max() <= REL_TOL and norm.max() <= NORM_REL_TOL


def test_two_ranks_step_as_one_process_and_follow_the_jax_run(trajectory):
    jax_rows, rows = trajectory
    loss, norm = _rel(rows[:, 0], rows[:, 1]), _rel(rows[:, 2], rows[:, 3])
    coupled = _rel(rows[:, 0], jax_rows[:RANK_STEPS, 0])
    print(f'FarSeg-{TRUNK} {SIZE}², {RANK_STEPS} steps over 2 ranks against the one-process step '
          f'from the same state: loss {loss.max():.3e}, gradient norm {norm.max():.3e}, new '
          f'state {rows[:, 4].max():.3e}; against the coupled JAX losses: steps 1-'
          f'{BEFORE_SEPARATION} {coupled[:BEFORE_SEPARATION].max():.3e}, all '
          f'{RANK_STEPS} {coupled.max():.3e}')
    assert loss.max() <= REL_TOL and norm.max() <= REL_TOL and rows[:, 4].max() <= REL_TOL
    assert coupled[:BEFORE_SEPARATION].max() <= REL_TOL
