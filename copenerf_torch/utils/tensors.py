"""Ways to bring indices and constants to the card without waiting for it.

Indexing a tensor by a 0-dim tensor copies the index to the host first
(``.item()``), and ``torch.tensor([...], device="cuda")`` copies its
values from pageable host memory; either makes the host wait until the
card has run everything queued before it. The helpers here give the same
values from operations the card runs in its queue, so the host can run
ahead of it.
"""

from __future__ import annotations

import functools

import torch


def take(table: torch.Tensor, idx) -> torch.Tensor:
    """``table[idx]`` along dim 0 for a Python int or an integer tensor of
    one element: a tensor index is gathered by ``index_select`` (a copy of
    the row, which autograd differentiates by ``index_add``), never read
    on the host."""
    if not isinstance(idx, torch.Tensor):
        return table[idx]
    return table.index_select(0, idx.reshape(1)).squeeze(0)


def scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-dim tensor of ``value`` (a number or a tensor) on ``device``: a
    number is filled in on the device, not copied from the host."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=device)
    return torch.full((), value, dtype=dtype, device=device)


@functools.cache
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """The 1-D tensor of ``values`` on ``device``, copied there once per
    (values, dtype, device) and shared by every caller: read it, never
    write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
