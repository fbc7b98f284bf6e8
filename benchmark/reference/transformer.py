"""Plain float32 encoder-decoder Transformer, the benchmark's reference.

Vaswani et al. 2017's model as the port trains it: pre-LN layers,
sinusoidal positions, tied input and output embeddings, einsum
attention with causal and key-padding masks, and the masked
cross-entropy over the non-pad target tokens. Where the port follows
flax's numerics, so does this: LayerNorm with eps 1e-6 and the variance
E[x^2] - E[x]^2 (clamped at 0), gelu's tanh approximation, the
embedding scaled by nothing. Every product is float32 here (the
products of `products.Products`), with TF32 off.

Parameters are a dict keyed by the names of `param_spec`, which the
harness fills from the run's seed. The batch is (src, tgt) token arrays
(B, Ts) and (B, Tt + 1), pad id 0; the decoder reads tgt[:, :-1] and
predicts tgt[:, 1:].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .products import Products

# Token slots (rows x length) a block of the reference's loss takes at
# once, so that its float32 scores fit beside the batch.
BLOCK_SLOTS = 8192


def param_spec(cfg: dict) -> list:
    """(name, shape, init, trainable) of every tensor of the model; init
    is `lecun` (normal, variance 1 / fan-in), `embed` (normal, std 0.02),
    `zeros` or `ones`."""
    d, ff, layers = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    spec = [("shared_embedding.weight", (cfg["vocab_size"], d), "embed", True)]

    def dense(name, fan_out, fan_in):
        spec.append((f"{name}.weight", (fan_out, fan_in), "lecun", True))
        spec.append((f"{name}.bias", (fan_out,), "zeros", True))

    def norm(name):
        spec.append((f"{name}.weight", (d,), "ones", True))
        spec.append((f"{name}.bias", (d,), "zeros", True))

    def layer(prefix, decoder):
        for attn in ("self_attn", "cross_attn") if decoder else ("self_attn",):
            for part in ("query", "key", "value", "out"):
                dense(f"{prefix}.{attn}.{part}", d, d)
        for i in range(3 if decoder else 2):
            norm(f"{prefix}.norms.{i}")
        dense(f"{prefix}.mlp.0", ff, d)
        dense(f"{prefix}.mlp.1", d, ff)

    for i in range(layers):
        layer(f"enc.{i}", False)
    for i in range(layers):
        layer(f"dec.{i}", True)
    norm("enc_norm")
    norm("dec_norm")
    return spec


def sinusoidal_positions(length: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64, device=device)
                    / dim * -math.log(10000.0))
    table = torch.zeros(length, dim, dtype=torch.float64, device=device)
    table[:, 0::2] = torch.sin(pos * div)
    table[:, 1::2] = torch.cos(pos * div)
    return table.float()


def layer_norm(x, p, name, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps) * p[f"{name}.weight"] + p[f"{name}.bias"]


class Transformer:
    """The forward pass and the loss over one batch."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        self.cfg = cfg
        self.mm = Products(precision)

    def dense(self, x, p, name):
        return self.mm.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])

    def attention(self, xq, xkv, p, name, causal, key_mask):
        heads = self.cfg["num_heads"]
        b, tq, d = xq.shape
        tk, hd = xkv.shape[1], d // heads
        q = self.dense(xq, p, f"{name}.query").view(b, tq, heads, hd)
        k = self.dense(xkv, p, f"{name}.key").view(b, tk, heads, hd)
        v = self.dense(xkv, p, f"{name}.value").view(b, tk, heads, hd)
        scores = self.mm.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        visible = key_mask[:, None, None, :]
        if causal:
            visible = visible & torch.ones(tq, tk, dtype=torch.bool,
                                           device=xq.device).tril()
        scores = scores.masked_fill(~visible, torch.finfo(torch.float32).min)
        out = self.mm.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        return self.dense(out.reshape(b, tq, d), p, f"{name}.out")

    def layer(self, x, p, prefix, self_mask, enc=None, cross_mask=None):
        eps = self.cfg["layer_norm_eps"]
        decoder = enc is not None
        y = layer_norm(x, p, f"{prefix}.norms.0", eps)
        x = x + self.attention(y, y, p, f"{prefix}.self_attn", decoder, self_mask)
        if decoder:
            y = layer_norm(x, p, f"{prefix}.norms.1", eps)
            x = x + self.attention(y, enc, p, f"{prefix}.cross_attn", False, cross_mask)
        y = layer_norm(x, p, f"{prefix}.norms.{2 if decoder else 1}", eps)
        y = F.gelu(self.dense(y, p, f"{prefix}.mlp.0"), approximate="tanh")
        return x + self.dense(y, p, f"{prefix}.mlp.1")

    def logits(self, p, src, tgt_in):
        cfg, eps = self.cfg, self.cfg["layer_norm_eps"]
        emb = p["shared_embedding.weight"]
        pos = sinusoidal_positions(max(src.shape[1], tgt_in.shape[1]), cfg["d_model"],
                                   src.device)
        src_mask, tgt_mask = src != 0, tgt_in != 0
        x = emb[src] + pos[: src.shape[1]]
        for i in range(cfg["num_layers"]):
            x = self.layer(x, p, f"enc.{i}", src_mask)
        enc = layer_norm(x, p, "enc_norm", eps)
        y = emb[tgt_in] + pos[: tgt_in.shape[1]]
        for i in range(cfg["num_layers"]):
            y = self.layer(y, p, f"dec.{i}", tgt_mask, enc, src_mask)
        y = layer_norm(y, p, "dec_norm", eps)
        return torch.einsum("bld,vd->blv", y, emb)  # tied, float32

    def count(self, batch) -> torch.Tensor:
        """The number of target tokens the loss averages over."""
        return (batch[1][:, 1:] != 0).sum()

    def row_blocks(self, batch):
        rows = max(1, BLOCK_SLOTS // batch[0].shape[1])
        return [slice(r, r + rows) for r in range(0, batch[0].shape[0], rows)]

    def loss_sum(self, p, batch, rows: slice, state=None) -> torch.Tensor:
        """The summed cross-entropy over the non-pad targets of `rows`."""
        src, tgt = batch[0][rows], batch[1][rows]
        logits = self.logits(p, src, tgt[:, :-1])
        targets = tgt[:, 1:]
        losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1), reduction="none")
        return (losses * (targets != 0).reshape(-1).float()).sum()
