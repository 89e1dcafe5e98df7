"""NeRF positional encoding: input first, then sin/cos per log-sampled
frequency 2^0 .. 2^(multires-1) — the reference's channel order, which the
SDF MLP's first-layer weights depend on."""

from __future__ import annotations

import torch


def embedder(multires: int, input_dims: int = 3):
    """Returns (embed_fn, out_dim)."""
    if multires <= 0:
        return (lambda x: x), input_dims
    freqs = [2.0 ** i for i in range(multires)]

    def embed(x):
        parts = [x]
        for f in freqs:
            parts.append(torch.sin(x * f))
            parts.append(torch.cos(x * f))
        return torch.cat(parts, dim=-1)

    return embed, input_dims * (1 + 2 * multires)
