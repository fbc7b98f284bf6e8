"""Autoencoder recommender (ML-20M-class workloads).

The port of `shockwave_tpu/models/recommendation.py`: a multi-hot
interaction row in, reconstruction scores out, multinomial
log-likelihood loss. The first LayerNorm is f32 (eps 1e-6, the fast
variance, as flax's); the hidden dense layers compute in bf16 (input,
weight and bias cast to it, as `nn.Dense(dtype=bf16)`); the output
layer computes in f32. Parameters are f32, drawn as flax draws them
(lecun-normal kernels, zero biases) from an explicit `torch.Generator`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import LayerNorm, dense, lecun_normal_


class AutoEncoder(nn.Module):
    def __init__(self, num_items: int = 20108, hidden_dims: Sequence[int] = (200,),
                 dtype=torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_items = num_items
        self.dtype = dtype
        self.norm = LayerNorm(num_items)
        widths = [num_items, *hidden_dims]
        self.enc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        back = list(reversed(hidden_dims))
        self.dec = nn.ModuleList(nn.Linear(a, b) for a, b in zip(back, back[1:]))
        self.out = nn.Linear(hidden_dims[0], num_items)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for layer in (*self.enc, *self.dec, self.out):
                lecun_normal_(layer.weight, layer.in_features, generator)
                layer.bias.zero_()

    def forward(self, interactions):
        """interactions: (batch, num_items) multi-hot float -> scores (f32)."""
        x = self.norm(interactions).to(self.dtype)
        for layer in (*self.enc, *self.dec):
            x = torch.tanh(dense(layer, x, self.dtype))
        return dense(self.out, x, torch.float32)


def multinomial_nll(logits, targets):
    """Multinomial negative log-likelihood over interaction rows."""
    return -(F.log_softmax(logits, dim=-1) * targets).sum(dim=-1).mean()
