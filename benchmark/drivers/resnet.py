"""The port's ResNet-50 under the benchmark.

The `Trainer` is the ImageNet main's own: `imagenet/main.build_trainer`
with the mix's batch size (SGD with momentum 0.9 at lr 0.1, TF32 off,
the CIFAR-10 main's `loss_fn`), on the run's device.

Work counts: the model FLOPs of a step are the convolutions and the
dense head, the backward counted as twice the forward, less the stem's
input gradient, which no input needs.
"""
from __future__ import annotations

from shockwave_tpu_torch.workloads.image_classification.imagenet.main import (
    build_trainer as _build)

from ..reference import resnet as reference

param_spec = reference.param_spec


def Reference(cfg, precision="float32"):
    return reference.ResNet(cfg, precision)


def build_trainer(cfg: dict, mix: dict, device: str):
    return _build(["-b", str(mix["batch"]), "--device", device])


def launches_per_step(cfg: dict) -> dict:
    return {}


def _conv_macs(cfg: dict, h: int, w: int):
    """(stem MACs, all MACs) of one image's forward pass."""
    def out(n, k, s, pad=None):
        return (n + 2 * pad - k) // s + 1 if pad is not None else -(-n // s)
    h, w = out(h, 7, 2, 3), out(w, 7, 2, 3)
    stem = h * w * cfg["num_filters"] * cfg["channels"] * 49
    total = stem
    h, w = out(h, 3, 2), out(w, 3, 2)  # the max-pool
    for _, cin, filters, stride, proj in reference.blocks(cfg):
        total += h * w * cin * filters  # 1x1
        ho, wo = out(h, 3, stride), out(w, 3, stride)
        total += ho * wo * filters * filters * 9 + ho * wo * filters * filters * 4
        if proj:
            total += ho * wo * cin * filters * 4
        h, w = ho, wo
    width = reference.blocks(cfg)[-1][2] * 4
    return stem, total + width * cfg["num_classes"]


def model_flops(cfg: dict, lengths: dict) -> float:
    stem, total = _conv_macs(cfg, *lengths["hw"])
    return lengths["b"] * 2.0 * (3 * total - 2 * stem)


def attention_calls(cfg: dict, lengths: dict) -> list:
    return []
