"""Carry weights from flax parameter trees to the port's `state_dict`s.

Each input is a tree from `model.init(...)` of the JAX package's model
(`["params"]`, and for ResNet also `["batch_stats"]`), given as nested
dicts of numpy arrays (the caller does the `np.asarray`; nothing here
imports JAX). Every leaf is consumed exactly once: a missing leaf raises
`KeyError`, a left-over one `ValueError`.

`flax_to_state_dict`, for `Seq2SeqTransformer`:
  DenseGeneral query/key/value  kernel (D, H, Dh) -> weight (H*Dh, D)
                                bias (H, Dh)      -> bias (H*Dh,)
  DenseGeneral out              kernel (H, Dh, D) -> weight (D, H*Dh)
  Dense_i                       kernel (in, out)  -> mlp.i.weight (out, in)
  LayerNorm_i                   scale, bias       -> norms.i.weight, .bias
  shared_embedding/embedding, enc_norm, dec_norm
`lm_flax_to_state_dict`, for `LSTMLanguageModel`:
  StackedLSTMCell_0/lstm_l  ii|if|ig|io kernels (in, H) -> weight_ih_l (4H, in)
                            hi|hf|hg|ho kernels (H, H)  -> weight_hh_l (4H, H)
                            hi|hf|hg|ho biases          -> bias_hh_l; bias_ih_l = 0
`recoder_flax_to_state_dict`, for `AutoEncoder`: LayerNorm_0, enc_i,
  dec_i, out.
`resnet_flax_to_state_dict`, for `ResNet`:
  Conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw)
  BatchNorm scale, bias; batch_stats mean, var -> running_mean, running_var
  <Block>_k/Conv_j, BatchNorm_j -> blocks.k.convs.j, blocks.k.norms.j
`decoder_flax_to_state_dict`, for `DecoderLM`: embed/embedding,
  block_i/self_attn/{query,key,value,out} as the Transformer's attention,
  block_i/{norm1,norm2,mlp_in,mlp_out}, final_norm.
`a3c_flax_to_state_dict`, for `ActorCritic`: Conv_i -> convs.i (with
  its bias), Dense_i -> dense.i.
`cyclegan_flax_to_state_dict`, for `Generator` and `Discriminator`:
  Conv_i -> convs.i, InstanceNorm_i -> norms.i, ResidualBlock_i ->
  blocks.i, and ConvTranspose_i kernel (3, 3, in, out) -> ups.i.weight
  (in, out, 3, 3) flipped in H and W (`models/cyclegan.py` says why).
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


class _Leaves:
    """The leaves of a flax tree by path, each taken exactly once."""

    def __init__(self, tree: Mapping):
        self.flat = _flatten(tree)

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"flax parameter tree has no leaf {path!r}")
        return self.flat.pop(path)

    def done(self) -> None:
        if self.flat:
            raise ValueError(f"flax leaves left over: {sorted(self.flat)}")


def _attention(take, src: str, dst: str, sd: dict) -> None:
    """DenseGeneral query/key/value (D, H, Dh) and out (H, Dh, D)."""
    for name in ("query", "key", "value"):
        kernel = take(f"{src}/{name}/kernel")  # (D, H, Dh)
        sd[f"{dst}.{name}.weight"] = _tensor(kernel.reshape(kernel.shape[0], -1).T)
        sd[f"{dst}.{name}.bias"] = _tensor(take(f"{src}/{name}/bias").reshape(-1))
    kernel = take(f"{src}/out/kernel")  # (H, Dh, D)
    sd[f"{dst}.out.weight"] = _tensor(kernel.reshape(-1, kernel.shape[-1]).T)
    sd[f"{dst}.out.bias"] = _tensor(take(f"{src}/out/bias"))


def _norm(take, src: str, dst: str, sd: dict) -> None:
    """A flax norm's scale and bias."""
    sd[f"{dst}.weight"] = _tensor(take(f"{src}/scale"))
    sd[f"{dst}.bias"] = _tensor(take(f"{src}/bias"))


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax `Seq2SeqTransformer` tree."""
    leaves = _Leaves(params)
    flat, take = leaves.flat, leaves.take
    sd: Dict[str, torch.Tensor] = {}
    sd["shared_embedding.weight"] = _tensor(take("shared_embedding/embedding"))
    layers = sorted({m.group(1, 2) for m in (re.match(r"(enc|dec)_(\d+)/", p)
                                             for p in flat) if m})
    for side, index in layers:
        src, dst = f"{side}_{index}", f"{side}.{index}"
        _attention(take, f"{src}/self_attn", f"{dst}.self_attn", sd)
        if side == "dec":
            _attention(take, f"{src}/cross_attn", f"{dst}.cross_attn", sd)
        for i in range(3 if side == "dec" else 2):
            _norm(take, f"{src}/LayerNorm_{i}", f"{dst}.norms.{i}", sd)
        for i in range(2):
            sd[f"{dst}.mlp.{i}.weight"] = _tensor(take(f"{src}/Dense_{i}/kernel").T)
            sd[f"{dst}.mlp.{i}.bias"] = _tensor(take(f"{src}/Dense_{i}/bias"))
    _norm(take, "enc_norm", "enc_norm", sd)
    _norm(take, "dec_norm", "dec_norm", sd)
    leaves.done()
    return sd


def lm_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax `LSTMLanguageModel` tree."""
    leaves = _Leaves(params)
    take = leaves.take
    sd = {"embedding.weight": _tensor(take("embedding/embedding")),
          "proj.weight": _tensor(take("proj/kernel").T),
          "proj.bias": _tensor(take("proj/bias"))}
    layers = sorted({int(m.group(1)) for m in (
        re.match(r"StackedLSTMCell_0/lstm_(\d+)/", p) for p in leaves.flat) if m})
    for layer in layers:
        src = f"StackedLSTMCell_0/lstm_{layer}"
        w_ih = [take(f"{src}/i{g}/kernel") for g in "ifgo"]
        w_hh = [take(f"{src}/h{g}/kernel") for g in "ifgo"]
        b_hh = [take(f"{src}/h{g}/bias") for g in "ifgo"]
        sd[f"lstm.weight_ih_l{layer}"] = _tensor(np.concatenate(w_ih, axis=1).T)
        sd[f"lstm.weight_hh_l{layer}"] = _tensor(np.concatenate(w_hh, axis=1).T)
        sd[f"lstm.bias_ih_l{layer}"] = torch.zeros(4 * b_hh[0].shape[0])
        sd[f"lstm.bias_hh_l{layer}"] = _tensor(np.concatenate(b_hh))
    leaves.done()
    return sd


def _dense(take, src: str, dst: str, sd: dict) -> None:
    sd[f"{dst}.weight"] = _tensor(take(f"{src}/kernel").T)
    sd[f"{dst}.bias"] = _tensor(take(f"{src}/bias"))


def recoder_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax `AutoEncoder` (Recoder) tree."""
    leaves = _Leaves(params)
    take = leaves.take
    sd = {"norm.weight": _tensor(take("LayerNorm_0/scale")),
          "norm.bias": _tensor(take("LayerNorm_0/bias"))}
    for side in ("enc", "dec"):
        count = len({p.split("/")[0] for p in leaves.flat if p.startswith(f"{side}_")})
        for i in range(count):
            _dense(take, f"{side}_{i}", f"{side}.{i}", sd)
    _dense(take, "out", "out", sd)
    leaves.done()
    return sd


def resnet_flax_to_state_dict(params: Mapping,
                              batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict (parameters and BatchNorm buffers) for a
    flax `ResNet` tree and its `batch_stats`."""
    leaves, stats = _Leaves(params), _Leaves(batch_stats)
    take = leaves.take
    sd: Dict[str, torch.Tensor] = {}

    def conv(src: str, dst: str) -> None:
        sd[f"{dst}.weight"] = _tensor(take(f"{src}/kernel").transpose(3, 2, 0, 1))

    def norm(src: str, dst: str) -> None:
        sd[f"{dst}.weight"] = _tensor(take(f"{src}/scale"))
        sd[f"{dst}.bias"] = _tensor(take(f"{src}/bias"))
        sd[f"{dst}.running_mean"] = _tensor(stats.take(f"{src}/mean"))
        sd[f"{dst}.running_var"] = _tensor(stats.take(f"{src}/var"))

    conv("conv_init", "conv_init")
    norm("bn_init", "bn_init")
    blocks = sorted({m.group(1, 2) for m in (
        re.match(r"((?:ResNet|Bottleneck)Block)_(\d+)/", p) for p in leaves.flat) if m},
        key=lambda kind_index: int(kind_index[1]))
    for kind, index in blocks:
        src, dst = f"{kind}_{index}", f"blocks.{index}"
        convs = sorted(p.split("/")[1] for p in leaves.flat
                       if p.startswith(f"{src}/Conv_"))
        for j in range(len(convs)):
            conv(f"{src}/Conv_{j}", f"{dst}.convs.{j}")
            norm(f"{src}/BatchNorm_{j}", f"{dst}.norms.{j}")
        if f"{src}/conv_proj/kernel" in leaves.flat:
            conv(f"{src}/conv_proj", f"{dst}.conv_proj")
            norm(f"{src}/norm_proj", f"{dst}.norm_proj")
    _dense(take, "Dense_0", "head", sd)
    leaves.done()
    stats.done()
    return sd


def _conv(take, src: str, dst: str, sd: dict) -> None:
    """A flax Conv kernel (kh, kw, in, out) and its bias."""
    sd[f"{dst}.weight"] = _tensor(take(f"{src}/kernel").transpose(3, 2, 0, 1))
    sd[f"{dst}.bias"] = _tensor(take(f"{src}/bias"))


def _indices(flat, pattern: str):
    """The sorted integer suffixes of the top-level modules `pattern`_i."""
    return sorted({int(m.group(1)) for m in (re.match(pattern + r"_(\d+)/", p) for p in flat) if m})


def decoder_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax `DecoderLM` tree."""
    leaves = _Leaves(params)
    take = leaves.take
    sd = {"embed.weight": _tensor(take("embed/embedding"))}
    for i in _indices(leaves.flat, "block"):
        src, dst = f"block_{i}", f"blocks.{i}"
        _attention(take, f"{src}/self_attn", f"{dst}.self_attn", sd)
        for name in ("norm1", "norm2"):
            _norm(take, f"{src}/{name}", f"{dst}.{name}", sd)
        for name in ("mlp_in", "mlp_out"):
            _dense(take, f"{src}/{name}", f"{dst}.{name}", sd)
    _norm(take, "final_norm", "final_norm", sd)
    leaves.done()
    return sd


def a3c_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax `ActorCritic` tree."""
    leaves = _Leaves(params)
    sd: Dict[str, torch.Tensor] = {}
    for i in _indices(leaves.flat, "Conv"):
        _conv(leaves.take, f"Conv_{i}", f"convs.{i}", sd)
    for i in _indices(leaves.flat, "Dense"):
        _dense(leaves.take, f"Dense_{i}", f"dense.{i}", sd)
    leaves.done()
    return sd


def cyclegan_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a flax CycleGAN `Generator` or
    `Discriminator` tree."""
    leaves = _Leaves(params)
    sd: Dict[str, torch.Tensor] = {}

    def convs_and_norms(take, flat, src: str, dst: str) -> None:
        prefix = f"{src}/" if src else ""
        local = [p[len(prefix):] for p in flat if p.startswith(prefix)]
        for i in _indices(local, "Conv"):
            _conv(take, f"{prefix}Conv_{i}", f"{dst}convs.{i}", sd)
        for i in _indices(local, "InstanceNorm"):
            _norm(take, f"{prefix}InstanceNorm_{i}", f"{dst}norms.{i}", sd)

    convs_and_norms(leaves.take, leaves.flat, "", "")
    for i in _indices(leaves.flat, "ResidualBlock"):
        convs_and_norms(leaves.take, list(leaves.flat), f"ResidualBlock_{i}", f"blocks.{i}.")
    for i in _indices(leaves.flat, "ConvTranspose"):
        kernel = leaves.take(f"ConvTranspose_{i}/kernel")  # (kh, kw, in, out)
        sd[f"ups.{i}.weight"] = _tensor(kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        sd[f"ups.{i}.bias"] = _tensor(leaves.take(f"ConvTranspose_{i}/bias"))
    leaves.done()
    return sd
