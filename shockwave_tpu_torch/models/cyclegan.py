"""CycleGAN generators and discriminators, on PyTorch.

The port of `shockwave_tpu/models/cyclegan.py`: Zhu et al.'s ResNet-block
generator and 70x70 PatchGAN discriminator, with instance norm, bf16
compute and f32 parameters. Images are NHWC at the public functions, as
in the JAX package; inside, the models view them as NCHW (a
channels-last layout in memory on the card; contiguous NCHW on the CPU,
see `models/resnet.py`). They follow flax's numerics:

- a convolution (`Conv`) has a bias, and computes as flax's
  `Conv(dtype=bf16)`: input and kernel cast to bf16, the bf16 product,
  then the bias added in bf16; `SAME` padding is XLA's
  (`resnet.same_pads`), which pads a 4x4 stride-1 window by (1, 2) and a
  3x3 stride-2 window on an even input by (0, 1);
- instance norm takes f32 statistics over H and W with the biased
  variance and eps 1e-5, and its output is bf16;
- flax's `ConvTranspose((3, 3), strides=2, padding="SAME")` is its kernel,
  as stored, cross-correlated over the input dilated by 2 and padded by
  (2, 1). That is `conv_transpose2d` with the kernel flipped, no padding,
  and the last row and column cropped: `ConvTranspose` stores the
  flipped kernel in `conv_transpose2d`'s (in, out, kh, kw) layout
  (`convert.cyclegan_flax_to_state_dict` flips it);
- `leaky_relu(x, 0.2)` and the generator's tanh run in bf16; both
  models return f32.

Parameters are drawn as flax draws them (lecun-normal kernels, zero
biases, unit norm scales) from an explicit `torch.Generator`, on the
CPU; move the module to its device afterwards.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import resnet
from .transformer import lecun_normal_


class Conv(resnet.Conv):
    """flax `nn.Conv(dtype=bf16)` with its bias, padding `SAME`."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__(cin, cout, kernel, stride, dtype=dtype)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return super().forward(x) + self.bias.to(self.dtype).view(1, -1, 1, 1)


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose(cout, (3, 3), strides=(2, 2), padding="SAME",
    dtype=bf16)`: doubles H and W. `weight` is (cin, cout, 3, 3), the flax
    kernel flipped in H and W (see the module docstring)."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), stride=2)
        return y[..., :-1, :-1] + self.bias.to(self.dtype).view(1, -1, 1, 1)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization (no running statistics), f32
    statistics, output in `dtype`."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype=torch.bfloat16):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=(2, 3), correction=0, keepdim=True)
        y = (x32 - mean) / torch.sqrt(var + self.eps)
        return (y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)).to(self.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.convs = nn.ModuleList(Conv(features, features, 3, dtype=dtype) for _ in range(2))
        self.norms = nn.ModuleList(InstanceNorm(features, dtype=dtype) for _ in range(2))

    def forward(self, x):
        y = F.relu(self.norms[0](self.convs[0](x)))
        return x + self.norms[1](self.convs[1](y))


def _nchw(images, dtype):
    """NHWC f32 images as the NCHW bf16 view the convolutions take."""
    x = images.to(dtype).permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


def _init(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initializers: lecun-normal kernels over their fan-in."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, ConvTranspose):
                lecun_normal_(m.weight, m.weight.shape[0] * 9, generator)


class Generator(nn.Module):
    """c7s1-64, d128, d256, R256 x num_blocks, u128, u64, c7s1-3: flax's
    Conv_0..3 (`convs`), InstanceNorm_0..4 (`norms`), ResidualBlock_i
    (`blocks`) and ConvTranspose_0..1 (`ups`)."""

    def __init__(self, base_features: int = 64, num_blocks: int = 6,
                 dtype=torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        f, self.dtype = base_features, dtype
        self.convs = nn.ModuleList([Conv(3, f, 7, dtype=dtype), Conv(f, 2 * f, 3, 2, dtype),
                                    Conv(2 * f, 4 * f, 3, 2, dtype), Conv(f, 3, 7, dtype=dtype)])
        self.norms = nn.ModuleList(InstanceNorm(c, dtype=dtype)
                                   for c in (f, 2 * f, 4 * f, 2 * f, f))
        self.blocks = nn.ModuleList(ResidualBlock(4 * f, dtype) for _ in range(num_blocks))
        self.ups = nn.ModuleList([ConvTranspose(4 * f, 2 * f, dtype), ConvTranspose(2 * f, f, dtype)])
        _init(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, images):
        """(B, H, W, 3) f32 -> (B, H, W, 3) f32 in [-1, 1]."""
        x = _nchw(images, self.dtype)
        for conv, norm in zip(self.convs[:3], self.norms[:3]):
            x = F.relu(norm(conv(x)))
        for block in self.blocks:
            x = block(x)
        for up, norm in zip(self.ups, self.norms[3:]):
            x = F.relu(norm(up(x)))
        return torch.tanh(self.convs[3](x)).float().permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """70x70 PatchGAN: C64-C128-C256-C512 -> 1-channel patch logits;
    flax's Conv_0..4 (`convs`) and InstanceNorm_0..2 (`norms`)."""

    def __init__(self, base_features: int = 64, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f, self.dtype = base_features, dtype
        widths = (3, f, 2 * f, 4 * f, 8 * f)
        self.convs = nn.ModuleList(
            [Conv(widths[i], widths[i + 1], 4, 2 if i < 3 else 1, dtype) for i in range(4)]
            + [Conv(8 * f, 1, 4, dtype=dtype)])
        self.norms = nn.ModuleList(InstanceNorm(c, dtype=dtype) for c in widths[2:])
        _init(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, images):
        """(B, H, W, 3) f32 -> (B, H/8, W/8, 1) f32 patch logits."""
        x = _nchw(images, self.dtype)
        for i, conv in enumerate(self.convs[:4]):
            x = conv(x)
            if i > 0:
                x = self.norms[i - 1](x)
            x = F.leaky_relu(x, 0.2)
        return self.convs[4](x).float().permute(0, 2, 3, 1)


__all__ = ["Conv", "ConvTranspose", "InstanceNorm", "ResidualBlock", "Generator",
           "Discriminator"]
