"""Plain float32 ResNet-50, the benchmark's reference.

He et al. 2016's ResNet-50 with the ImageNet stem (7x7 stride-2
convolution, 3x3 stride-2 max-pool), bottleneck blocks of 3, 4, 6 and 3
with the stride on the 3x3 convolution (as flax's and torchvision's
ResNet-50 place it), a mean over H and W and a dense head, trained on
the mean cross-entropy. It follows flax's numerics, as the port does:
`SAME` padding (a 3x3 stride-2 window on an even input pads (0, 1), the
max-pool with -inf), BatchNorm with the biased batch variance, eps
1e-5, and running statistics updated as 0.9 * running + 0.1 * batch.
Every product is float32 here (TF32 off); images arrive NHWC float32.

BatchNorm couples the rows of a batch, so the loss is taken over the
whole batch at once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .products import Products


def same_pads(size: int, kernel: int, stride: int):
    """(low, high) padding of XLA's `SAME` for one spatial dimension."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def blocks(cfg: dict):
    """(prefix, cin, filters, stride, has_projection) of every bottleneck."""
    out, cin, j = [], cfg["num_filters"], 0
    for i, count in enumerate(cfg["stage_sizes"]):
        filters = cfg["num_filters"] * 2 ** i
        for b in range(count):
            stride = 2 if i > 0 and b == 0 else 1
            cout = filters * 4
            out.append((f"blocks.{j}", cin, filters, stride, cin != cout or stride != 1))
            cin, j = cout, j + 1
    return out


def param_spec(cfg: dict) -> list:
    """(name, shape, init, trainable) of every tensor of the model; the
    BatchNorm running statistics are the untrained ones. The last
    BatchNorm of each block starts with a zero scale, as the job's model
    (flax's ResNet) starts it, so that each block starts as its shortcut."""
    spec = []

    def conv(name, cout, cin, k):
        spec.append((f"{name}.weight", (cout, cin, k, k), "lecun", True))

    def norm(name, c, scale="ones"):
        spec.extend([(f"{name}.weight", (c,), scale, True),
                     (f"{name}.bias", (c,), "zeros", True),
                     (f"{name}.running_mean", (c,), "zeros", False),
                     (f"{name}.running_var", (c,), "ones", False)])

    stem = cfg["num_filters"]
    conv("conv_init", stem, cfg["channels"], 7)
    norm("bn_init", stem)
    for prefix, cin, filters, _, proj in blocks(cfg):
        conv(f"{prefix}.convs.0", filters, cin, 1)
        conv(f"{prefix}.convs.1", filters, filters, 3)
        conv(f"{prefix}.convs.2", filters * 4, filters, 1)
        for i, c in enumerate((filters, filters, filters * 4)):
            norm(f"{prefix}.norms.{i}", c, "zeros" if i == 2 else "ones")
        if proj:
            conv(f"{prefix}.conv_proj", filters * 4, cin, 1)
            norm(f"{prefix}.norm_proj", filters * 4)
    width = blocks(cfg)[-1][2] * 4
    spec.append(("head.weight", (cfg["num_classes"], width), "lecun", True))
    spec.append(("head.bias", (cfg["num_classes"],), "zeros", True))
    return spec


class ResNet:
    """The forward pass in training mode and the loss over one batch."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        self.cfg = cfg
        self.mm = Products(precision)

    def conv(self, x, p, name, stride=1, padding=None):
        w = p[f"{name}.weight"]
        if padding is None:
            (top, bottom), (left, right) = (same_pads(n, w.shape[-1], stride)
                                            for n in x.shape[2:])
            x, padding = F.pad(x, (left, right, top, bottom)), 0
        return self.mm.conv2d(x, w, stride, padding)

    def norm(self, x, p, state, name):
        momentum, eps = self.cfg["bn_momentum"], self.cfg["bn_eps"]
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            for key, batch in (("running_mean", mean), ("running_var", var)):
                state[f"{name}.{key}"].mul_(momentum).add_(batch, alpha=1 - momentum)
        shape = (1, -1, 1, 1)
        x_hat = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
        return x_hat * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape)

    def logits(self, p, state, images):
        x = images.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.norm(self.conv(x, p, "conv_init", 2, 3), p, state, "bn_init"))
        (top, bottom), (left, right) = (same_pads(n, 3, 2) for n in x.shape[2:])
        x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)
        for prefix, _, _, stride, proj in blocks(self.cfg):
            y = F.relu(self.norm(self.conv(x, p, f"{prefix}.convs.0"), p, state,
                                 f"{prefix}.norms.0"))
            y = F.relu(self.norm(self.conv(y, p, f"{prefix}.convs.1", stride), p, state,
                                 f"{prefix}.norms.1"))
            y = self.norm(self.conv(y, p, f"{prefix}.convs.2"), p, state, f"{prefix}.norms.2")
            if proj:
                x = self.norm(self.conv(x, p, f"{prefix}.conv_proj", stride), p, state,
                              f"{prefix}.norm_proj")
            x = F.relu(x + y)
        return F.linear(x.mean(dim=(2, 3)), p["head.weight"], p["head.bias"])  # float32

    def count(self, batch) -> int:
        return batch[1].shape[0]

    def row_blocks(self, batch):
        return [slice(None)]

    def loss_sum(self, p, batch, rows: slice, state) -> torch.Tensor:
        images, labels = batch[0][rows], batch[1][rows]
        return F.cross_entropy(self.logits(p, state, images), labels, reduction="sum")
