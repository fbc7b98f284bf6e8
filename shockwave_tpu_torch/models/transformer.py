"""Encoder-decoder Transformer for translation (Multi30k-class workloads).

The port of `shockwave_tpu/models/transformer.py`: pre-LN layers, tied
output projection, bf16 compute with f32 parameters and f32 LayerNorm.
It follows the flax model's numerics where they differ from PyTorch's
habits:

- LayerNorm uses eps 1e-6 and the variance E[x^2] - E[x]^2 (clamped at
  0), as flax's `nn.LayerNorm` does by default;
- the MLP activation is gelu's tanh approximation (flax `nn.gelu`);
- a dense layer casts both its input and its weight to the compute
  dtype and adds the bias in that dtype, as `DenseGeneral(dtype=bf16)`;
- the embedding is rounded to the compute dtype before the f32 positions
  are added, so the residual stream is f32 and each sub-layer's bf16
  output is added onto it;
- the tied logits are an f32 product against the f32 embedding (the
  trainer turns TF32 off on the card for it).

Parameters are drawn as flax draws them (truncated-normal lecun_normal
for dense kernels, zero biases, normal(0.02) embedding), from an explicit
`torch.Generator`, on the CPU; move the module to its device afterwards.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention

# flax's truncated_normal variance_scaling divides by the std of a unit
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    """flax's lecun_normal: truncated normal with variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) / dim * -np.log(10000.0))
    table = np.zeros((length, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=float32)`: f32 statistics with the fast
    variance, eps 1e-6, f32 output."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def dense(layer: nn.Linear, x, dtype):
    """`layer` applied as flax's Dense(dtype=dtype): input and weight cast
    to `dtype`, the product rounded to it, then the bias added in it."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class MultiHeadAttention(nn.Module):
    """Attention expressed as (causal, key_padding_mask) so it can go to
    the fused flash-attention kernels (ops/flash_attention.py) when
    `use_flash`; otherwise einsum attention. `query`, `key` and `value`
    hold the flax DenseGeneral (dim, heads, head_dim) kernels as
    (heads * head_dim, dim) weights; `out` holds (heads, head_dim, dim)."""

    def __init__(self, num_heads: int, dim: int, dtype=torch.bfloat16,
                 use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dim = dim
        self.dtype = dtype
        self.use_flash = use_flash
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in, causal: bool = False,
                key_padding_mask: Optional[torch.Tensor] = None):
        head_dim = self.dim // self.num_heads
        b, tq, tk = q_in.shape[0], q_in.shape[1], kv_in.shape[1]
        q = dense(self.query, q_in, self.dtype).view(b, tq, self.num_heads, head_dim)
        k = dense(self.key, kv_in, self.dtype).view(b, tk, self.num_heads, head_dim)
        v = dense(self.value, kv_in, self.dtype).view(b, tk, self.num_heads, head_dim)
        # The JAX package's gate, kept as it is so that both packages take
        # the same path on the same shapes: flash for T > 1024 only in
        # 1024-blocks, shorter lengths aligned to the sublane tile (16 for
        # bf16, 8 for f32), causal only when Tq == Tk.
        align = 16 if self.dtype == torch.bfloat16 else 8

        def blockable(t):
            return t % 1024 == 0 if t > 1024 else t % align == 0

        flash_ok = (self.use_flash and not (causal and tq != tk)
                    and blockable(tq) and blockable(tk))
        if flash_ok:
            out = flash_attention(q, k, v, causal=causal,
                                  key_padding_mask=key_padding_mask)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head_dim)
            # The JAX einsum path's where() promotes the scores to f32.
            scores = scores.float()
            fmin = torch.finfo(torch.float32).min
            if causal:
                cmask = torch.ones(tq, tk, dtype=torch.bool,
                                   device=scores.device).tril()
                scores = torch.where(cmask, scores, fmin)
            if key_padding_mask is not None:
                scores = torch.where(key_padding_mask[:, None, None, :],
                                     scores, fmin)
            weights = torch.softmax(scores, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return dense(self.out, out.reshape(b, tq, self.dim), self.dtype)


class TransformerLayer(nn.Module):
    """Pre-LN layer. `norms` are flax's LayerNorm_0.. in order (self,
    [cross,] mlp); `mlp` is Dense_0, Dense_1."""

    def __init__(self, num_heads: int, dim: int, mlp_dim: int,
                 decoder: bool = False, dtype=torch.bfloat16,
                 use_flash: bool = False):
        super().__init__()
        self.decoder = decoder
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(num_heads, dim, dtype, use_flash)
        if decoder:
            self.cross_attn = MultiHeadAttention(num_heads, dim, dtype, use_flash)
        self.norms = nn.ModuleList(LayerNorm(dim) for _ in range(3 if decoder else 2))
        self.mlp = nn.ModuleList([nn.Linear(dim, mlp_dim), nn.Linear(mlp_dim, dim)])

    def forward(self, x, enc_out=None, self_padding=None, cross_padding=None):
        y = self.norms[0](x)
        x = x + self.self_attn(y, y, causal=self.decoder,
                               key_padding_mask=self_padding)
        if self.decoder:
            y = self.norms[1](x)
            x = x + self.cross_attn(y, enc_out, key_padding_mask=cross_padding)
        y = self.norms[-1](x)
        y = dense(self.mlp[0], y, self.dtype)
        y = F.gelu(y, approximate="tanh")
        y = dense(self.mlp[1], y, self.dtype)
        return x + y


class Seq2SeqTransformer(nn.Module):
    def __init__(self, vocab_size: int = 9521, dim: int = 512,
                 num_heads: int = 8, num_layers: int = 6, mlp_dim: int = 2048,
                 max_len: int = 64, dtype=torch.bfloat16,
                 use_flash: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.shared_embedding = nn.Embedding(vocab_size, dim)
        self.register_buffer(
            "positions", torch.from_numpy(sinusoidal_positions(max_len, dim)),
            persistent=False)
        self.enc = nn.ModuleList(
            TransformerLayer(num_heads, dim, mlp_dim, dtype=dtype,
                             use_flash=use_flash) for _ in range(num_layers))
        self.dec = nn.ModuleList(
            TransformerLayer(num_heads, dim, mlp_dim, decoder=True,
                             dtype=dtype, use_flash=use_flash)
            for _ in range(num_layers))
        self.enc_norm = LayerNorm(dim)
        self.dec_norm = LayerNorm(dim)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from `generator` (a CPU generator;
        call before moving the module to its device)."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                lecun_normal_(module.weight, module.in_features, generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
        nn.init.normal_(self.shared_embedding.weight, std=0.02,
                        generator=generator)

    def forward(self, src_tokens, tgt_tokens):
        src = self.shared_embedding(src_tokens).to(self.dtype)
        src = src + self.positions[: src_tokens.shape[1]]
        src_padding = src_tokens != 0
        for layer in self.enc:
            src = layer(src, self_padding=src_padding)
        src = self.enc_norm(src)

        tgt = self.shared_embedding(tgt_tokens).to(self.dtype)
        tgt = tgt + self.positions[: tgt_tokens.shape[1]]
        tgt_padding = tgt_tokens != 0
        for layer in self.dec:
            tgt = layer(tgt, enc_out=src, self_padding=tgt_padding,
                        cross_padding=src_padding)
        tgt = self.dec_norm(tgt)
        # Tied output projection (-proj_share_weight), in f32.
        return torch.einsum("bld,vd->blv", tgt.float(),
                            self.shared_embedding.weight.float())
