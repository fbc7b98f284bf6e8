"""Decoder-only LM with an explicit KV cache for autoregressive serving.

The port of `shockwave_tpu/models/decoder.py`. The serving replica
(`workloads/serving/serve.py`) decodes tokens one at a time through the
cache: each layer's projected K/V are written at the token's position
and the new token's query attends over the cache with a masked einsum (a
1-token query has no flash-block shape). The full-sequence forward keeps
the JAX package's gate: with `use_flash` and a blockable length it runs
the port's flash attention (K1, `ops/flash_attention.py`), causal.

It follows the flax model's numerics as `models/transformer.py` does
(flax's LayerNorm, tanh gelu, dense layers cast to the compute dtype, the
embedding rounded to it before the f32 positions are added, f32 tied
logits). Two things differ from the JAX version in form only:

- `decode_step` writes the caches in place (the JAX version returns new
  ones), so a CUDA graph can replay a whole request batch on fixed
  buffers;
- positions are Python ints, so a graph captures each one unrolled.

On the card the flash path runs K1's bf16 or f32 instance, by the
decoder's dtype (f32 is `DecoderLM`'s default, as the JAX decoder runs
its Pallas K1 in f32); on the CPU it runs K1's plain version.

Parameters are drawn as flax draws them (lecun-normal dense kernels, zero
biases, normal(0.02) embedding) from an explicit `torch.Generator`, on
the CPU; move the module to its device afterwards.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from .transformer import LayerNorm, dense, lecun_normal_, sinusoidal_positions

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


class CachedSelfAttention(nn.Module):
    """Causal self-attention whose parameters serve both the
    full-sequence path and the one-token cached decode path. `query`,
    `key` and `value` hold the flax DenseGeneral (dim, heads, head_dim)
    kernels as (dim, dim) weights; `out` holds (heads, head_dim, dim)."""

    def __init__(self, num_heads: int, dim: int, dtype=torch.float32,
                 use_flash: bool = False):
        super().__init__()
        self.num_heads, self.dim, self.dtype = num_heads, dim, dtype
        self.use_flash = use_flash
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def _heads(self, layer, x):
        b, t, _ = x.shape
        return dense(layer, x, self.dtype).view(b, t, self.num_heads, -1)

    def _attend(self, q, k, v, visible):
        """The JAX einsum path: bf16 scores promoted to f32 by the where
        against an f32 minimum, softmax in f32, weights in the dtype."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
        scores = torch.where(visible, scores.float(), torch.finfo(torch.float32).min)
        weights = torch.softmax(scores, dim=-1).to(self.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v)

    def forward(self, x):
        """Full-sequence causal attention (the same gate as
        transformer.MultiHeadAttention: flash for T > 1024 only in
        1024-blocks, shorter lengths aligned to 16 in bf16, 8 otherwise)."""
        q, k, v = (self._heads(layer, x) for layer in (self.query, self.key, self.value))
        b, t = x.shape[:2]
        align = 16 if self.dtype == torch.bfloat16 else 8
        blockable = t % 1024 == 0 if t > 1024 else t % align == 0
        if self.use_flash and blockable:
            attended = flash_attention(q, k, v, causal=True)
        else:
            causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            attended = self._attend(q, k, v, causal)
        return dense(self.out, attended.reshape(b, t, self.dim), self.dtype)

    def decode(self, x, k_cache, v_cache, pos: int):
        """One-token step: write this position's K/V into the caches (in
        place) and attend the query over every cached position <= pos.
        x: (B, 1, D); caches: (B, T, H, Dh)."""
        q = self._heads(self.query, x)
        k_cache[:, pos:pos + 1] = self._heads(self.key, x)
        v_cache[:, pos:pos + 1] = self._heads(self.value, x)
        visible = torch.arange(k_cache.shape[1], device=x.device) <= pos
        attended = self._attend(q, k_cache, v_cache, visible)
        return dense(self.out, attended.reshape(x.shape[0], 1, self.dim), self.dtype)


class DecoderBlock(nn.Module):
    """Pre-LN block: flax's self_attn, LayerNorm_0/1 (`norm1`, `norm2`),
    Dense_0/1 (`mlp_in`, `mlp_out`)."""

    def __init__(self, num_heads: int, dim: int, mlp_dim: int, dtype=torch.float32,
                 use_flash: bool = False):
        super().__init__()
        self.dtype = dtype
        self.self_attn = CachedSelfAttention(num_heads, dim, dtype, use_flash)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp_in = nn.Linear(dim, mlp_dim)
        self.mlp_out = nn.Linear(mlp_dim, dim)

    def _mlp(self, x):
        y = F.gelu(dense(self.mlp_in, x, self.dtype), approximate="tanh")
        return dense(self.mlp_out, y, self.dtype)

    def forward(self, x):
        x = x + self.self_attn(self.norm1(x))
        return x + self._mlp(self.norm2(x))

    def decode(self, x, k_cache, v_cache, pos: int):
        x = x + self.self_attn.decode(self.norm1(x), k_cache, v_cache, pos)
        return x + self._mlp(self.norm2(x))


class DecoderLM(nn.Module):
    """Small decoder-only LM for token serving (sized for one card; the
    serving workload scales by replica count, not model size)."""

    def __init__(self, vocab_size: int = 256, dim: int = 128, num_heads: int = 4,
                 num_layers: int = 2, mlp_dim: int = 256, max_len: int = 128,
                 dtype=torch.float32, use_flash: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size, self.dim, self.num_heads = vocab_size, dim, num_heads
        self.max_len, self.dtype = max_len, dtype
        self.embed = nn.Embedding(vocab_size, dim)
        self.register_buffer(
            "positions", torch.from_numpy(sinusoidal_positions(max_len, dim)),
            persistent=False)
        self.blocks = nn.ModuleList(
            DecoderBlock(num_heads, dim, mlp_dim, dtype, use_flash) for _ in range(num_layers))
        self.final_norm = LayerNorm(dim)
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
        nn.init.normal_(self.embed.weight, std=0.02, generator=generator)

    def _logits(self, x):
        # Tied output projection, in f32.
        return torch.einsum("bld,vd->blv", self.final_norm(x).float(),
                            self.embed.weight.float())

    def forward(self, tokens):
        """Full-sequence causal logits (B, T, V) f32."""
        x = self.embed(tokens).to(self.dtype) + self.positions[: tokens.shape[1]]
        for block in self.blocks:
            x = block(x)
        return self._logits(x)

    def decode_step(self, token, caches: Caches, pos: int):
        """One autoregressive step. token: (B, 1) ids at position `pos`;
        caches from `init_cache`, updated in place. Returns the logits
        (B, 1, V) f32."""
        x = self.embed(token).to(self.dtype) + self.positions[pos:pos + 1]
        for block, (k_cache, v_cache) in zip(self.blocks, caches):
            x = block.decode(x, k_cache, v_cache, pos)
        return self._logits(x)

    def init_cache(self, batch: int, device=None) -> Caches:
        shape = (batch, self.max_len, self.num_heads, self.dim // self.num_heads)
        device = device if device is not None else self.embed.weight.device
        return [(torch.zeros(shape, dtype=self.dtype, device=device),
                 torch.zeros(shape, dtype=self.dtype, device=device))
                for _ in self.blocks]


def decode_tokens(model: DecoderLM, prompt, caches: Caches, num_tokens: int):
    """Greedy decode on given caches: zero them, prefill the prompt
    through the cache token by token, then extend `num_tokens` tokens.
    Returns the (B, num_tokens) generated ids; the serving replica's
    unit of work, and what `serve.py` captures as one CUDA graph."""
    for k_cache, v_cache in caches:
        k_cache.zero_()
        v_cache.zero_()
    prompt_len = prompt.shape[1]
    for i in range(prompt_len):
        logits = model.decode_step(prompt[:, i:i + 1], caches, i)
    generated = []
    for j in range(num_tokens):
        generated.append(torch.argmax(logits[:, -1], dim=-1, keepdim=True))
        logits = model.decode_step(generated[-1], caches, prompt_len + j)
    return torch.cat(generated, dim=1)


@torch.no_grad()
def greedy_decode(model: DecoderLM, prompt, num_tokens: int):
    """Greedy autoregressive generation from fresh caches (the JAX
    package's `greedy_decode`): (B, num_tokens) generated ids."""
    return decode_tokens(model, prompt, model.init_cache(prompt.shape[0]), num_tokens)


__all__ = ["CachedSelfAttention", "DecoderBlock", "DecoderLM", "decode_tokens",
           "greedy_decode"]
