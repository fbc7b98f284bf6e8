"""ResNets: ResNet-18 (CIFAR-10 stem) and ResNet-50 (ImageNet stem).

The port of `shockwave_tpu/models/resnet.py`. Images arrive NHWC f32, as
the loaders yield them; the model casts them to bf16 and views them as
NCHW (a channels-last layout in memory, on the card). Convolutions compute in bf16
with f32 parameters; BatchNorm runs in f32, so the residual stream is
f32 from the first norm on; the head is a mean over H and W and an f32
dense layer. It follows flax's numerics where they differ from
PyTorch's habits:

- `SAME` padding: a 3x3 stride-2 window on an even input pads (0, 1),
  not PyTorch's (1, 1), and so does the stem's 3x3 stride-2 max-pool
  (with -inf); `same_pads` works the pads out from the input's size.
- BatchNorm (`BatchNorm` below): flax's momentum 0.9 on the running
  statistics, eps 1e-5, and the running variance follows the biased
  batch variance (`nn.BatchNorm2d` would take the unbiased one). The
  last BatchNorm of each block starts with a zero scale. In a gang the
  batch statistics are the global batch's, as in the JAX package's one
  jit over the dp-sharded global array: `_SyncBatchNorm` all-reduces
  them across the ranks (`nn.SyncBatchNorm` refuses CPU tensors).

Parameters are drawn as flax draws them (lecun-normal kernels, unit
scales, zero biases) from an explicit `torch.Generator`, on the CPU;
move the module to its device afterwards.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .transformer import lecun_normal_


def same_pads(size: int, kernel: int, stride: int):
    """(low, high) padding of XLA's `SAME` for one spatial dimension."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv(use_bias=False, dtype=bf16)`, padding `SAME` unless
    given: input and kernel cast to bf16, the output bf16."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        x, weight = x.to(self.dtype), self.weight.to(self.dtype)
        pad = self.padding
        if pad is None:
            k = self.weight.shape[-1]
            (top, bottom), (left, right) = (same_pads(n, k, self.stride)
                                            for n in x.shape[2:])
            if (top, left) == (bottom, right):
                pad = top
            else:
                x, pad = F.pad(x, (left, right, top, bottom)), 0
        return F.conv2d(x, weight, stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`:
    f32 batch statistics in training, and running statistics updated as
    `0.9 * running + 0.1 * batch` with the biased batch variance. In a
    gang the statistics are the global batch's (`_SyncBatchNorm`), unless
    `local_statistics` is set (the trainer sets it while it runs GNS's
    small batch, which takes one rank's own statistics)."""

    def __init__(self, channels: int, zero_scale: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.full((channels,), 0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.local_statistics = False

    def forward(self, x):
        x = x.to(self.weight.dtype)  # f32, the parameters' dtype
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if mesh.process_count() > 1 and not self.local_statistics:
            out, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps)
        else:
            out, mean, rstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = (rstd.detach().double().pow(-2) - self.eps).clamp_min(0.0).to(x.dtype)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return out


class _SyncBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over the gang's global batch, for NCHW f32
    `x`. Forward all-reduces each rank's (count, count x mean, count x
    (var + mean^2)) per channel, from this rank's two-pass `var_mean`, in
    float64; backward all-reduces (sum dy, sum dy x_hat). Returns the
    output and the global mean and biased variance (for the running
    statistics). The parameter gradients are this rank's part; the
    trainer's gradient all-reduce sums them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = (0, 2, 3)
        var_r, mean_r = torch.var_mean(x, dims, correction=0)
        n_r = torch.full_like(mean_r, x.numel() // x.shape[1], dtype=torch.float64)
        sums = torch.stack([n_r, n_r * mean_r.double(),
                            n_r * (var_r.double() + mean_r.double() ** 2)])
        mesh.all_reduce_sum(sums)
        n = sums[0]
        mean64 = sums[1] / n
        var64 = (sums[2] / n - mean64 ** 2).clamp_min(0.0)
        mean, var = mean64.to(x.dtype), var64.to(x.dtype)
        rstd = torch.rsqrt(var64 + eps).to(x.dtype)
        shape = (1, -1, 1, 1)
        x_hat = (x - mean.view(shape)) * rstd.view(shape)
        ctx.save_for_backward(x_hat, weight, rstd)
        ctx.count = n
        ctx.mark_non_differentiable(mean, var)
        return x_hat * weight.view(shape) + bias.view(shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x_hat, weight, rstd = ctx.saved_tensors
        dims, shape = (0, 2, 3), (1, -1, 1, 1)
        sum_dy = dy.sum(dims)  # this rank's bias and weight gradients
        sum_dy_xhat = (dy * x_hat).sum(dims)
        sums = torch.stack([sum_dy, sum_dy_xhat])
        mesh.all_reduce_sum(sums)
        n = ctx.count.to(dy.dtype)
        mean_dy = (sums[0] / n).view(shape)
        mean_dy_xhat = (sums[1] / n).view(shape)
        dx = (weight * rstd).view(shape) * (dy - mean_dy - x_hat * mean_dy_xhat)
        return dx, sum_dy_xhat, sum_dy, None


class ResNetBlock(nn.Module):
    """Two 3x3 convolutions; flax's Conv_0, Conv_1, BatchNorm_0,
    BatchNorm_1 and, where the shape changes, conv_proj and norm_proj."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.convs = nn.ModuleList([Conv(cin, filters, 3, stride, dtype=dtype),
                                    Conv(filters, filters, 3, dtype=dtype)])
        self.norms = nn.ModuleList([BatchNorm(filters), BatchNorm(filters, zero_scale=True)])
        self._projection(cin, filters, stride, dtype)

    def _projection(self, cin, cout, stride, dtype):
        self.conv_proj = self.norm_proj = None
        if cin != cout or stride != 1:
            self.conv_proj = Conv(cin, cout, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(cout)

    def forward(self, x):
        y = x
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y))
            if i < len(self.convs) - 1:
                y = F.relu(y)
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(ResNetBlock):
    """1x1, strided 3x3, 1x1 (x4) convolutions."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.bfloat16):
        nn.Module.__init__(self)
        cout = filters * 4
        self.convs = nn.ModuleList([Conv(cin, filters, 1, dtype=dtype),
                                    Conv(filters, filters, 3, stride, dtype=dtype),
                                    Conv(filters, cout, 1, dtype=dtype)])
        self.norms = nn.ModuleList([BatchNorm(filters), BatchNorm(filters),
                                    BatchNorm(cout, zero_scale=True)])
        self._projection(cin, cout, stride, dtype)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int,
                 num_filters: int = 64, small_stem: bool = False,
                 dtype=torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.small_stem = small_stem
        if small_stem:
            self.conv_init = Conv(3, num_filters, 3, dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(cin, filters, 2 if i > 0 and j == 0 else 1, dtype))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, Conv):
                    lecun_normal_(module.weight, module.weight[0].numel(), generator)
            lecun_normal_(self.head.weight, cin, generator)
            self.head.bias.zero_()

    def forward(self, images):
        """images: (batch, H, W, 3) f32 -> logits (batch, num_classes) f32."""
        x = images.to(self.conv_init.dtype).permute(0, 3, 1, 2)  # channels-last
        if not x.is_cuda:
            # PyTorch's CPU channels-last convolutions (torch 2.13, several
            # threads, batch 2) corrupt the heap; NCHW there.
            x = x.contiguous()
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.small_stem:
            (top, bottom), (left, right) = (same_pads(n, 3, 2) for n in x.shape[2:])
            x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")),
                             3, 2)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


def ResNet18(num_classes: int = 10, **kwargs) -> ResNet:
    return ResNet((2, 2, 2, 2), ResNetBlock, num_classes, small_stem=True, **kwargs)


def ResNet50(num_classes: int = 1000, **kwargs) -> ResNet:
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes, **kwargs)
