"""LSTM language model (Wikitext-2-class workloads).

The port of `shockwave_tpu/models/lm.py`: an embedding, a stack of LSTM
layers run over the sequence from a zero carry, and a dense projection
to the vocabulary, all in f32. The recurrence is `nn.LSTM` (cuDNN's on
the card; the trainer turns TF32 off for it).

flax's `OptimizedLSTMCell` keeps its gate kernels apart: input kernels
`ii/if/ig/io` of shape (in, H) carry no bias, hidden kernels
`hi/hf/hg/ho` of shape (H, H) carry it. PyTorch's gate order is the same
(i, f, g, o), so `weight_ih` is the input kernels side by side,
transposed, `weight_hh` the hidden ones, `bias_ih` is zero and frozen
(a trained second bias would take each gate's bias gradient twice), and
`bias_hh` holds the hidden biases (`convert.lm_flax_to_state_dict`).

Parameters are drawn as flax draws them where it is cheap (normal
embedding with variance 1/embed_dim, lecun-normal kernels, orthogonal
hidden kernels, zero biases), from an explicit `torch.Generator`, on the
CPU; move the module to its device afterwards.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .transformer import lecun_normal_


class LSTMLanguageModel(nn.Module):
    def __init__(self, vocab_size: int = 33278, embed_dim: int = 256,
                 hidden_size: int = 256, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.lstm = nn.LSTM(embed_dim, hidden_size, num_layers=num_layers,
                            batch_first=True)
        self.proj = nn.Linear(hidden_size, vocab_size)
        for layer in range(num_layers):
            getattr(self.lstm, f"bias_ih_l{layer}").requires_grad_(False)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        dim = self.embedding.embedding_dim
        nn.init.normal_(self.embedding.weight, std=math.sqrt(1.0 / dim),
                        generator=generator)
        hidden = self.lstm.hidden_size
        for layer in range(self.lstm.num_layers):
            w_ih = getattr(self.lstm, f"weight_ih_l{layer}")
            w_hh = getattr(self.lstm, f"weight_hh_l{layer}")
            lecun_normal_(w_ih, w_ih.shape[1], generator)
            for gate in range(4):
                nn.init.orthogonal_(w_hh[gate * hidden:(gate + 1) * hidden],
                                    generator=generator)
            getattr(self.lstm, f"bias_ih_l{layer}").zero_()
            getattr(self.lstm, f"bias_hh_l{layer}").zero_()
        lecun_normal_(self.proj.weight, self.proj.in_features, generator)
        self.proj.bias.zero_()

    def forward(self, tokens):
        """tokens: (batch, seq_len) int -> logits (batch, seq_len, vocab)."""
        hidden, _ = self.lstm(self.embedding(tokens))  # zero initial (h, c)
        return self.proj(hidden)
