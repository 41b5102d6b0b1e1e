"""Port parity for the host schedules (``training/schedules.py``): the port's
warmup, annealing, NeuS cos ratio, ``MultiStepLR`` and ``LRState`` against
the JAX package's, step by step, and ``MultiStepLR`` against torch's
scheduler (the off-by-one the JAX package's trajectory parity once caught:
a milestone takes effect from its own epoch's first iteration).

The ``LRState`` run crosses the warmup, an lr half-drop, a MultiStepLR
milestone inside the warmup (which the next warmup overwrite erases), a
milestone after it and a stage-2 reset; every resume point replays the
trained epochs (``replay_epoch``) and must continue exactly as the
uninterrupted run. All comparisons are exact: both packages run the same
float64 arithmetic on the host.
"""

import numpy as np
import pytest
import torch

from copenerf_tpu.training import schedules as JS
from copenerf_torch.training import schedules as TS

# 6 iterations an epoch; warmup over 20 iterations (epochs 0-3); milestones
# range(2, 10, 10) ... at epochs 2 (inside the warmup) and 12; a half-drop
# at epoch 5; stage 2 from epoch 8.
ITS = 6
EPOCHS = 16
STAGE2 = 8
CFG = {"learning_rate": 1e-3, "pose_learning_rate": 5e-4,
       "scheduler_gamma": 0.5, "motion_scheduler_gamma": 0.25,
       "scheduling_start": 2, "scheduling_epoch": 11, "nb_warm_up_it": 20,
       "lr_drop_half_epoch": [5]}


def run(mod, start_epoch=0):
    """The trainer's per-epoch / per-iteration mutation sequence from
    ``start_epoch`` (replaying the epochs before it): [(it, lr, motion_lr)]."""
    state = mod.LRState(dict(CFG))
    for e in range(start_epoch):
        state.replay_epoch(e, ITS, stage2_starts_now=(e == STAGE2))
    out = []
    for e in range(start_epoch, EPOCHS):
        state.on_epoch_start(e, stage2_starts_now=(e == STAGE2))
        for it in range(e * ITS, (e + 1) * ITS):
            out.append((it,) + state.lrs(it))
        state.on_epoch_end(e)
    return out


def test_lr_state_matches_jax():
    got, ref = run(TS), run(JS)
    assert got == ref
    lrs = {it: lr for it, lr, _ in got}
    # The milestone at epoch 2 fired inside the warmup and was overwritten.
    assert lrs[20] == CFG["learning_rate"]
    assert lrs[21] == CFG["learning_rate"]
    assert lrs[5 * ITS] == CFG["learning_rate"] / 2      # the half-drop
    assert lrs[STAGE2 * ITS] == CFG["learning_rate"]     # the stage-2 reset
    assert lrs[12 * ITS] == CFG["learning_rate"] / 2     # milestone at 12


@pytest.mark.parametrize("start_epoch", [1, 3, 4, 6, 9, 13])
def test_resume_replay_matches_uninterrupted(start_epoch):
    """A resume at ``start_epoch`` continues as the uninterrupted run, in
    the port and in the JAX package alike."""
    full = run(TS)[start_epoch * ITS:]
    assert run(TS, start_epoch) == full
    assert run(JS, start_epoch) == full


@pytest.mark.parametrize("n", [0, 1, 7, 20, 25])
def test_scalar_schedules_match_jax(n):
    assert TS.warmup_factor(n, 20) == JS.warmup_factor(n, 20)
    assert TS.warmup_factor(n, 0) == JS.warmup_factor(n, 0)
    assert TS.cos_anneal_ratio(n, 10.0) == JS.cos_anneal_ratio(n, 10.0)
    assert TS.cos_anneal_ratio(n, 0.0) == JS.cos_anneal_ratio(n, 0.0)
    args = (n, 2.0, 22.0, 0.1, 1.0)
    assert TS.scalar_annealing(*args) == JS.scalar_annealing(*args)


def torch_epoch_lrs(base_lr, milestones, gamma, num_epochs):
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=base_lr)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones=list(milestones), gamma=gamma)
    lrs = []
    for _ in range(num_epochs):
        lrs.append(opt.param_groups[0]["lr"])
        sched.step()
    return lrs


@pytest.mark.parametrize("base_lr,milestones,gamma,n", [
    (0.001, range(0, 300, 60), 0.5, 300),
    (0.001, range(30, 10000, 10), 0.9, 200),
    (0.1, [3, 7, 8], 0.25, 12),
])
def test_multistep_lr_matches_torch_and_jax(base_lr, milestones, gamma, n):
    got = TS.MultiStepLR(base_lr, milestones, gamma)
    ref = JS.MultiStepLR(base_lr, milestones, gamma)
    lrs = [got.epoch_lr(e) for e in range(n)]
    assert lrs == [ref.epoch_lr(e) for e in range(n)]
    np.testing.assert_allclose(lrs, torch_epoch_lrs(base_lr, milestones,
                                                    gamma, n), rtol=1e-12)
