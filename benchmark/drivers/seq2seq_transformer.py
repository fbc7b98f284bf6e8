"""The port's translation Transformer under the benchmark.

The `Trainer` is built as `workloads/translation/train.build_trainer`
builds it (SGD with momentum 0.9, the config's learning rate, TF32 off
through `resolve_device`, `loss_fn` of the same main), with flash
attention on and one departure: the model's `max_len` is the config's,
since `build_trainer` fixes 64 and the cells run longer sequences.

Work counts: the model FLOPs of a step are the products that the
inputs need (dense layers over the real tokens, attention over the
visible pairs of the real queries, the tied logits over the real target
positions), the backward counted as twice the forward. The attention
calls of a step (`attention_calls`) give the least time of K1-K3 and
delta for `attn_roofline`.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from shockwave_tpu_torch.models.train_common import Trainer, resolve_device
from shockwave_tpu_torch.models.transformer import Seq2SeqTransformer
from shockwave_tpu_torch.workloads.translation.train import loss_fn

from ..counts import KERNELS, prefix_mask
from ..reference import transformer as reference

param_spec = reference.param_spec


def Reference(cfg, precision="float32"):
    return reference.Transformer(cfg, precision)


def build_trainer(cfg: dict, mix: dict, device: str) -> Trainer:
    model = Seq2SeqTransformer(
        vocab_size=cfg["vocab_size"], dim=cfg["d_model"], num_heads=cfg["num_heads"],
        num_layers=cfg["num_layers"], mlp_dim=cfg["d_ff"], max_len=cfg["max_len"],
        use_flash=True, generator=torch.Generator().manual_seed(0))
    return Trainer(SimpleNamespace(), loss_fn, model, None, device=resolve_device(device),
                   learning_rate=cfg["optimizer"]["lr"], mode="static",
                   initial_bs=max(b for _, b in mix["buckets"]), max_bs=128)


def launches_per_step(cfg: dict) -> dict:
    """K1, delta, K2 and K3 once for each attention of a step: self
    attention in every layer and cross attention in the decoder's."""
    return {k: 3 * cfg["num_layers"] for k in KERNELS}


def model_flops(cfg: dict, lengths: dict) -> float:
    d, ff, layers, vocab = cfg["d_model"], cfg["d_ff"], cfg["num_layers"], cfg["vocab_size"]
    ls = np.asarray(lengths["src"], dtype=np.float64)
    lt = np.asarray(lengths["tgt"], dtype=np.float64)  # decoder positions with a target
    mlp = 4 * d * ff
    enc = ls.sum() * (8 * d * d + mlp) + 4 * d * (ls * ls).sum()
    dec = (lt.sum() * (8 * d * d + 4 * d * d + mlp) + ls.sum() * 4 * d * d
           + 4 * d * (lt * (lt + 1) / 2).sum() + 4 * d * (lt * ls).sum())
    logits = lt.sum() * 2 * d * vocab
    return 3.0 * (layers * (enc + dec) + logits)


def attention_calls(cfg: dict, lengths: dict) -> list:
    """(b, tq, tk, heads, head dim, causal, key mask) of every attention
    of one step, as the model hands them to `flash_attention`."""
    t, heads = lengths["t"], cfg["num_heads"]
    d = cfg["d_model"] // heads
    src = prefix_mask(lengths["src"], t)
    tgt_in = prefix_mask(np.minimum(np.asarray(lengths["tgt"]) + 1, t), t)
    b = src.shape[0]
    one_layer = [(b, t, t, heads, d, False, src)]
    one_layer_dec = [(b, t, t, heads, d, True, tgt_in), (b, t, t, heads, d, False, src)]
    return (one_layer + one_layer_dec) * cfg["num_layers"]
