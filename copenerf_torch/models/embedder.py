"""NeRF positional encoding (port of ``copenerf_tpu/models/embedder.py``).

For multires ``m`` and ``d``-dim input the encoding is

    [x, sin(x * 2^0), cos(x * 2^0), ..., sin(x * 2^(m-1)), cos(x * 2^(m-1))]

— the raw input followed by per-frequency sin/cos blocks of width ``d``,
giving ``d * (1 + 2m)`` channels. The JAX package's wide-lane expansion
matmul was a TPU layout choice; here the blocks are concatenated directly.
"""

from __future__ import annotations

import torch


def embed_dim(multires: int, input_dims: int) -> int:
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Encode ``x`` of shape (..., d) -> (..., d * (1 + 2 * multires))."""
    if multires <= 0:
        return x
    parts = [x]
    for k in range(multires):
        a = x * (2.0 ** k)
        parts.append(torch.sin(a))
        parts.append(torch.cos(a))
    return torch.cat(parts, dim=-1)
