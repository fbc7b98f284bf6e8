"""Carry `Seq2SeqTransformer` weights from the flax parameter tree to the
port's `state_dict`.

The input is the tree `model.init(...)["params"]` of
`shockwave_tpu.models.transformer.Seq2SeqTransformer`, given as nested
dicts of numpy arrays (the caller does the `np.asarray`; nothing here
imports JAX). Every leaf is consumed exactly once: a missing leaf raises
`KeyError`, a left-over one `ValueError`.

  DenseGeneral query/key/value  kernel (D, H, Dh) -> weight (H*Dh, D)
                                bias (H, Dh)      -> bias (H*Dh,)
  DenseGeneral out              kernel (H, Dh, D) -> weight (D, H*Dh)
  Dense_i                       kernel (in, out)  -> mlp.i.weight (out, in)
  LayerNorm_i                   scale, bias       -> norms.i.weight, .bias
  shared_embedding/embedding, enc_norm, dec_norm
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a contiguous, writable copy


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax `Seq2SeqTransformer` tree."""
    flat = _flatten(params)

    def take(path: str) -> np.ndarray:
        if path not in flat:
            raise KeyError(f"flax parameter tree has no leaf {path!r}")
        return flat.pop(path)

    sd: Dict[str, torch.Tensor] = {}

    def attention(src: str, dst: str) -> None:
        for name in ("query", "key", "value"):
            kernel = take(f"{src}/{name}/kernel")  # (D, H, Dh)
            sd[f"{dst}.{name}.weight"] = _tensor(
                kernel.reshape(kernel.shape[0], -1).T)
            sd[f"{dst}.{name}.bias"] = _tensor(
                take(f"{src}/{name}/bias").reshape(-1))
        kernel = take(f"{src}/out/kernel")  # (H, Dh, D)
        sd[f"{dst}.out.weight"] = _tensor(kernel.reshape(-1, kernel.shape[-1]).T)
        sd[f"{dst}.out.bias"] = _tensor(take(f"{src}/out/bias"))

    def norm(src: str, dst: str) -> None:
        sd[f"{dst}.weight"] = _tensor(take(f"{src}/scale"))
        sd[f"{dst}.bias"] = _tensor(take(f"{src}/bias"))

    sd["shared_embedding.weight"] = _tensor(take("shared_embedding/embedding"))
    layers = sorted({m.group(1, 2) for m in (re.match(r"(enc|dec)_(\d+)/", p)
                                             for p in flat) if m})
    for side, index in layers:
        src, dst = f"{side}_{index}", f"{side}.{index}"
        attention(f"{src}/self_attn", f"{dst}.self_attn")
        if side == "dec":
            attention(f"{src}/cross_attn", f"{dst}.cross_attn")
        for i in range(3 if side == "dec" else 2):
            norm(f"{src}/LayerNorm_{i}", f"{dst}.norms.{i}")
        for i in range(2):
            sd[f"{dst}.mlp.{i}.weight"] = _tensor(take(f"{src}/Dense_{i}/kernel").T)
            sd[f"{dst}.mlp.{i}.bias"] = _tensor(take(f"{src}/Dense_{i}/bias"))
    norm("enc_norm", "enc_norm")
    norm("dec_norm", "dec_norm")
    if flat:
        raise ValueError(f"flax leaves left over: {sorted(flat)}")
    return sd
