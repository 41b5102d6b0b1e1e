"""NaN/Inf sentinels (port of ``copenerf_tpu/utils/checks.py``; reference
``model/common.py:218-240``: ``check_weights`` / ``check_tensor`` — kept out
of the hot loop there and here; call them from host-side debugging hooks).
"""

from __future__ import annotations

import logging

import torch

logger_py = logging.getLogger(__name__)


def _named_parameters(params):
    """(name, tensor) of a module's parameters, or of a dict of modules
    (names prefixed by the dict's keys)."""
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    return [(f"{key}.{name}", p) for key, module in params.items()
            for name, p in module.named_parameters()]


def check_params(params) -> list:
    """Log any floating-point parameter containing NaN; returns the bad
    names. One host read for all of them."""
    named = [(n, p) for n, p in _named_parameters(params)
             if p.is_floating_point()]
    if not named:
        return []
    dev = named[0][1].device
    flags = torch.stack([torch.isnan(p.detach()).any().to(dev)
                         for _, p in named]).tolist()
    bad = [n for (n, _), flag in zip(named, flags) if flag]
    for name in bad:
        logger_py.warning("NaN values in param %s", name)
    return bad


def check_tensor(tensor: torch.Tensor, tensorname: str = "") -> bool:
    """Log when ``tensor`` contains NaN/Inf; returns True if it does. The
    test runs on the tensor's own device; one host read."""
    bad = bool((~torch.isfinite(tensor)).any())
    if bad:
        logger_py.warning("Tensor %s contains NaN or Inf values", tensorname)
    return bad
