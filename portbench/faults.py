"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them: a step that leaves its state unchanged;
half of the batch left out, the mean taken over the rest; an answer altered
where it is produced (the render core's color). One process holds one
card, so no cell has an exchange between cards to leave out.

    with planted("half_batch", "train"):
        ...   # the program, broken underneath
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "altered_answer")


def applicable(kind: str) -> tuple:
    """The faults a traffic kind can have: a render keeps no state."""
    return FAULTS[1:] if kind == "render" else FAULTS


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _half_batch(kind):
    if kind == "train":
        import copenerf_torch.training.step as mod
        orig = mod.compute_losses

        def half(fields, rcfg, s, batch, ray_idx, **kw):
            return orig(fields, rcfg, s, batch, ray_idx[:len(ray_idx) // 2],
                        **kw)
        return _patched(mod, "compute_losses", half)
    if kind == "eval_pose":
        import copenerf_torch.evaluation.evaluator as mod
        orig = mod.pose_loss

        def half(fields, rcfg, r, t, init, image, k, ray_idx, time_step,
                 near, far, **kw):
            n = len(ray_idx) // 2
            return orig(fields, rcfg, r, t, init, image, k, ray_idx[:n],
                        time_step, near[:n], far[:n], **kw)
        return _patched(mod, "pose_loss", half)
    from copenerf_torch.evaluation.render import ImageRenderer
    orig = ImageRenderer._chunk

    def half_chunk(self, fields, chunk, *args):
        res = orig(self, fields, chunk // 2, *args)
        return {k: torch.cat([v, v]) for k, v in res.items()}
    return _patched(ImageRenderer, "_chunk", half_chunk)


def _altered_answer():
    import copenerf_torch.ops.kernels.rendercore as mod
    orig = mod.rendercore_fwd

    def altered(sdf_net, color_net, x, dirs):
        sdf, grad, color = orig(sdf_net, color_net, x, dirs)
        bump = torch.zeros_like(color).reshape(-1, 3)
        bump[::7] = 0.01
        return sdf, grad, color + bump.reshape(color.shape)
    return _patched(mod, "rendercore_fwd", altered)


def planted(fault: str, kind: str):
    """A context in which the program runs with ``fault``."""
    if fault == "state_unchanged":
        return _patched(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    if fault == "half_batch":
        return _half_batch(kind)
    if fault == "altered_answer":
        return _altered_answer()
    raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
