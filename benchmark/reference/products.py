"""The products of the plain references, in float32 or, for the control,
in emulated fp8.

`Products("float32")` runs every product as a plain float32 one (the
caller turns TF32 off). `Products("fp8")` is the control's precision:
the step below the bf16 products that the configurations state. Each
operand is rounded to float8 e4m3 under a per-tensor scale (its largest
magnitude mapped to e4m3's largest finite value) before a float32
product, and the gradient that reaches a product's output is rounded to
float8 e5m2 under the same kind of scale: the usual fp8 training recipe,
with float32 accumulation. Products that the configurations state in
float32 (the Transformer's tied logits, the ResNet's dense head) stay
float32 in all three.

`Products("bf16")` is a witness, not a control: each operand, each
product's output and each gradient reaching a product's output rounded
to bfloat16 (round to nearest even, no scale), the precision the
configurations state, so that a gap between the program and the float32
reference can be told apart from bf16's own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, largest) -> torch.Tensor:
    """`x` rounded to `dtype` under a per-tensor scale (none where
    `largest` is None), back in x's dtype."""
    if largest is None:
        return x.to(dtype).to(x.dtype)
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / largest, torch.ones_like(amax))
    return ((x / scale).to(dtype).to(x.dtype)) * scale


# precision: (operand dtype, its scale's largest value, whether a
# product's output is rounded too, gradient dtype, its largest value)
ROUNDING = {"fp8": (torch.float8_e4m3fn, E4M3_MAX, False, torch.float8_e5m2, E5M2_MAX),
            "bf16": (torch.bfloat16, None, True, torch.bfloat16, None)}


class _Forward(torch.autograd.Function):
    """A tensor rounded; its gradient passes through."""

    @staticmethod
    def forward(ctx, x, dtype, largest):
        return _round(x, dtype, largest)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Backward(torch.autograd.Function):
    """The identity, whose incoming gradient is rounded."""

    @staticmethod
    def forward(ctx, x, dtype, largest):
        ctx.rounding = dtype, largest
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, *ctx.rounding), None, None


class Products:
    """The dense, attention and convolution products of a reference."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32",) + tuple(ROUNDING):
            raise ValueError(f"unknown precision {precision!r}")
        self.rounding = ROUNDING.get(precision)

    def _in(self, x):
        if self.rounding is None:
            return x
        return _Forward.apply(x, *self.rounding[:2])

    def _out(self, y):
        if self.rounding is None:
            return y
        dtype, largest, output, grad_dtype, grad_largest = self.rounding
        if output:
            y = _Forward.apply(y, dtype, largest)
        return _Backward.apply(y, grad_dtype, grad_largest)

    def linear(self, x, weight, bias=None):
        y = self._out(F.linear(self._in(x), self._in(weight)))
        return y if bias is None else y + bias

    def einsum(self, spec: str, a, b):
        return self._out(torch.einsum(spec, self._in(a), self._in(b)))

    def conv2d(self, x, weight, stride: int, padding: int):
        return self._out(F.conv2d(self._in(x), self._in(weight), stride=stride,
                                  padding=padding))
