"""What the drivers of ``portbench/drivers/<kind>.py`` share: the seed of
each iteration, the program's fields on the benchmark's weights, the
readings of a stepped unit and the numbers compared from them, and TF32 for
the control."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import scene

FIRST = 3            # units whose readings the reference follows


def iter_seed(seed: int, it: int) -> int:
    """The generator's seed at iteration ``it`` of run ``seed``."""
    return (int(seed) * 2 ** 20 + int(it)) % 2 ** 63


def program_cfg(cfg: dict) -> dict:
    """The configuration in the program's schema (its loader's sections)."""
    return {k: v for k, v in cfg.items() if isinstance(v, dict)}


def program_fields(cfg, weights, device):
    from copenerf_torch.models.fields import configs_from_cfg, init_all_fields

    fields = init_all_fields(configs_from_cfg(program_cfg(cfg)),
                             torch.Generator().manual_seed(0), device=device)
    scene.load_program_weights(fields, weights)
    return fields


def clone(weights: dict) -> dict:
    return {k: ([tuple(t.clone() for t in layer) for layer in v]
                if isinstance(v, list) else v.clone())
            for k, v in weights.items()}


def norm(t) -> float:
    return float(torch.linalg.norm(t.double())) if t is not None else 0.0


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap between two norms: |prog - ref| over the reference's
    norm of that leaf or of the median leaf, the larger."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return {}
    median = float(np.median([ref[k] for k in names]))
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30)
            for k in names}


def worst_leaf(prog: dict, ref: dict, keep=None):
    """(name, gap) of the leaf with the widest gap."""
    gaps = _leaf_gaps(prog, ref, keep)
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def step_readings(losses, grads, steps):
    return {"losses": losses, "grad_norms": grads, "step_norms": steps}


def moved_leaves(ref: dict) -> set:
    """Leaves that the reference moves: those whose first gradient is at
    least a thousandth of the median leaf's (the others move under Adam by
    round-off alone)."""
    g = ref["grad_norms"]
    median = float(np.median(list(g.values())))
    return {k for k, v in g.items() if v >= 1e-3 * median}


def compare_steps(prog: dict, ref: dict) -> dict:
    """The numbers compared for stepped cells: each step's loss (the widest
    relative gap), the first gradient as the optimizer got it and the
    parameters' change (each the worst leaf's gap of norms; the change of
    the leaves that the reference moves, of each step where
    ``step_norms`` is a list a step, the widest)."""
    lp, lr_ = prog["losses"], ref["losses"]
    if len(lp) != len(lr_) or not all(math.isfinite(a) for a in lp):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(lp, lr_))
    ps, rs = prog["step_norms"], ref["step_norms"]
    if isinstance(ps, dict):
        ps, rs = [ps], [rs]
    moved = moved_leaves(ref)
    return {"loss_gap": loss_gap,
            "grad_gap": max(_leaf_gaps(prog["grad_norms"],
                                       ref["grad_norms"]).values()),
            "step_gap": max(max(_leaf_gaps(p, r, moved).values())
                            for p, r in zip(ps, rs))}


def look(prog: dict, ref: dict) -> dict:
    """Readings beside the numbers compared, for the control's report:
    every step's loss gap and the worst leaves."""
    ps, rs = prog["step_norms"], ref["step_norms"]
    if isinstance(ps, dict):
        ps, rs = [ps], [rs]
    return {
        "loss_gaps": [abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(prog["losses"], ref["losses"])],
        "worst_grad": worst_leaf(prog["grad_norms"], ref["grad_norms"]),
        "worst_step": [worst_leaf(p, r, moved_leaves(ref))
                       for p, r in zip(ps, rs)]}




class tf32:
    """TF32 in every cuBLAS and cuDNN product on the card while the control
    computes (its operands are rounded by ``reference.nets`` too)."""

    def __init__(self, precision, device):
        self.on = precision == "tf32" and torch.device(device).type == "cuda"

    def __enter__(self):
        if self.on:
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        if self.on:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved
