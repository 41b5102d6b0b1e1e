"""Host-side learning-rate and loss-weight schedules (port copy of
``copenerf_tpu/training/schedules.py``).

Scalar schedules are computed on the host each step/epoch and fed into the
train step as Python floats — mirroring the reference's imperative
schedule handling (``train.py:116-123, 246-271, 341-368, 410-413``).
"""

from __future__ import annotations

import numpy as np


def warmup_factor(it: int, nb_warm_up_it: int) -> float:
    """Linear warmup factor over the first ``nb_warm_up_it`` iterations
    (reference ``neus_warmup_learning_rate``, train.py:265-271)."""
    if nb_warm_up_it <= 0:
        return 1.0
    return float(np.clip(it / nb_warm_up_it, 0.0, 1.0))


def scalar_annealing(it: float, start_anneal: float, end_anneal: float,
                     start_weight: float, end_weight: float) -> float:
    """Linear annealing (reference train.py:246-249)."""
    it = np.clip(it, start_anneal, end_anneal)
    frac = np.clip((it - start_anneal) / (end_anneal - start_anneal + 1e-10),
                   0.0, 1.0)
    return float(start_weight + (end_weight - start_weight) * frac)


def cos_anneal_ratio(it: int, anneal_end: float) -> float:
    """NeuS cos annealing (reference model/training.py:120-124)."""
    if anneal_end == 0.0:
        return 1.0
    return float(min(1.0, it / anneal_end))


class MultiStepLR:
    """Torch ``MultiStepLR`` semantics for host-side per-epoch loops.

    Torch decays the lr USED IN the milestone epoch: the scheduler's
    construction runs one implicit ``step()`` (last_epoch -1 -> 0, so a
    milestone at 0 means epoch 0 already runs at ``lr * gamma``), and the
    ``step()`` after epoch m-1 pushes ``last_epoch`` to milestone m before
    epoch m executes. Call :meth:`epoch_lr` once per epoch, in order.

    Golden-tested against ``torch.optim.lr_scheduler.MultiStepLR`` in
    ``tests/test_schedules_torch.py`` for both reference call sites
    (``eval.py:55-56`` milestones ``range(0, E, E/5)`` and
    ``utils_poses/pose_refinement.py:89-91`` milestones
    ``range(30, 10000, 10)``).
    """

    def __init__(self, base_lr: float, milestones, gamma: float):
        self.lr = float(base_lr)
        self.milestones = set(int(m) for m in milestones)
        self.gamma = float(gamma)

    def epoch_lr(self, epoch: int) -> float:
        """The lr in effect during ``epoch`` (epochs must be visited in
        ascending order starting at 0)."""
        if epoch in self.milestones:
            self.lr *= self.gamma
        return self.lr


class LRState:
    """Tracks the effective learning rates across stage resets, warmup,
    drops and MultiStepLR decay by replicating the reference trainer's
    MUTATIONS OF THE OPTIMIZER GROUP LR, in its order: lr_drop_half
    (:345-352), stage-2 reset (:360-368), warmup overwrite per iteration
    (:265-271, 410-413), scheduler.step() per epoch (:559-560).

    The mutation model matters: torch's MultiStepLR multiplies whatever the
    group currently holds, and the warmup OVERWRITES the group with
    ``base_lr * factor`` — so a milestone (or half-drop) that fires while
    warmup is still running is ERASED by the next overwrite. A closed-form
    ``base * gamma^decays`` model diverges there (caught by
    tests/test_trajectory_parity_stage2.py at it=31 with a milestone at
    epoch 2 inside a 30-it warmup).
    """

    def __init__(self, cfg_training: dict):
        self.base_lr = cfg_training["learning_rate"]
        self.base_motion_lr = cfg_training["pose_learning_rate"]
        self.gamma = cfg_training["scheduler_gamma"]
        self.motion_gamma = cfg_training["motion_scheduler_gamma"]
        self.scheduling_start = cfg_training["scheduling_start"]
        self.scheduling_epoch = cfg_training["scheduling_epoch"]
        self.warm_up_it = cfg_training["nb_warm_up_it"]
        self.lr_drop_half_epoch = list(cfg_training.get("lr_drop_half_epoch",
                                                        []) or [])
        # The mutable "optimizer group" lrs.
        self.cur_lr = self.base_lr
        self.cur_motion_lr = self.base_motion_lr

    def _milestones(self):
        return range(self.scheduling_start,
                     self.scheduling_epoch + self.scheduling_start, 10)

    def on_epoch_start(self, epoch: int, stage2_starts_now: bool):
        if epoch in self.lr_drop_half_epoch:
            self.cur_lr /= 2.0
            self.cur_motion_lr /= 2.0
        if stage2_starts_now:
            # Stage-2 transition resets field lr and freezes motion lr
            # (train.py:362-368); future milestones multiply from here.
            self.cur_lr = self.base_lr
            self.cur_motion_lr = 0.0

    def on_epoch_end(self, epoch: int):
        # torch MultiStepLR: scheduler.step() at the end of epoch e
        # increments last_epoch to e+1 and multiplies the CURRENT group lr
        # if e+1 is a milestone — milestone m takes effect from epoch m's
        # first iteration.
        if (epoch + 1) in self._milestones():
            self.cur_lr *= self.gamma
            self.cur_motion_lr *= self.motion_gamma

    def lrs(self, it: int):
        if 0 <= it <= self.warm_up_it:
            # Warmup OVERWRITES the field group lr (train.py:265-271);
            # the motion group is untouched (the reference's motion-warmup
            # block is commented out, :270-271).
            self.cur_lr = self.base_lr * warmup_factor(it, self.warm_up_it)
        return self.cur_lr, self.cur_motion_lr

    def replay_epoch(self, epoch: int, its_per_epoch: int,
                     stage2_starts_now: bool):
        """Fast-forward one already-trained epoch on resume: the same
        mutation sequence train() would have produced, without stepping."""
        self.on_epoch_start(epoch, stage2_starts_now)
        first_it = epoch * its_per_epoch
        last_it = first_it + its_per_epoch - 1
        if first_it <= self.warm_up_it:
            self.lrs(min(last_it, self.warm_up_it))
        self.on_epoch_end(epoch)
