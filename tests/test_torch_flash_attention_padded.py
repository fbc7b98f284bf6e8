"""The port's flash attention at head dims the kernels are not built for,
and the pad rule, against the JAX package's on the CPU.

Split from `test_torch_flash_attention.py` (whose helpers and tolerances
these tests use) so that the test workers can run the two side by side.
The JAX package's output and gradients come from one `jax.vjp` per
(d, dtype, causal), which the forward and the gradient test share.
"""
import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu.ops import flash_attention as jax_flash_attention
from shockwave_tpu_torch.ops import flash_attention as fa

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_flash_attention import (FWD_TOL, GRAD_TOL, _one_torch_thread,  # noqa: E402,F401
                                        rand_qkv, torch_grads, torch_out)

B, T, H = 2, 32, 2


def padded_inputs(d, dtype, causal):
    """f32 numpy q, k, v (B, T, H, d) and a key-padding mask with a padded
    tail; in bf16 both packages get the same bf16 values."""
    rng = np.random.RandomState(d + 2 * causal)
    q, k, v = rand_qkv(rng, B, T, H, d)
    kpm = np.arange(T)[None, :] < np.array([[T], [T // 2 + 3]])
    if dtype == "bfloat16":
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v))
    return q, k, v, kpm


@functools.lru_cache(maxsize=None)
def jax_reference(d, dtype, causal):
    """The JAX package's out and (dq, dk, dv) of the f32 sum of out
    squared, as f32 numpy, on `padded_inputs`: the cotangent of out is
    2 out rounded to out's dtype, as jax.grad of the sum forms it."""
    q, k, v, kpm = padded_inputs(d, dtype, causal)

    def attention(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal, key_padding_mask=jnp.asarray(kpm))

    out, vjp = jax.vjp(attention, *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)))
    grads = vjp((2 * out.astype(jnp.float32)).astype(out.dtype))
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


class TestPaddedHeadDimsAgainstJax:
    """Head dims the CUDA kernels are not built for (8, 16, 48, 80, 96,
    160, 320): the port's `flash_attention` zero-pads them to
    `kernel_head_dim` (32, 32, 64, 128, 128, 256, 512) on every device and
    slices the output back, so on the CPU the plain versions run the very
    pad and slice that the card runs; and d = 128, 256 and 512 (the wide
    instances' width), unpadded. The JAX package
    pads to its sublane multiple of 8 and runs Pallas (interpreted). Same numpy inputs, causal and non-causal, both with a
    padded key tail; out in the inputs' dtype, gradients of the f32 sum
    of out squared. Tolerances: f32 test_torch_flash_attention.py's
    (FWD_TOL, GRAD_TOL); bf16
    chip_smoke.py's bf16 ones, BF16_FWD_TOL abs on the output (both round
    p to bf16 before p.V and the output to bf16, and a rounding flip is
    one bf16 ulp, 3.9e-3 at |o| < 2) and BF16_GRAD_TOL on each gradient
    relative to its largest entry (dS and p rounded to bf16 in both)."""

    BF16_FWD_TOL, BF16_GRAD_TOL = 2e-2, 5e-2

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d", [8, 16, 48, 80, 96, 128, 160, 256, 320, 512])
    def test_forward(self, d, dtype, causal):
        q, k, v, kpm = padded_inputs(d, dtype, causal)
        fa.reset_launch_counts()
        out = torch_out(q, k, v, dtype, causal=causal, key_padding_mask=kpm)
        want, _ = jax_reference(d, dtype, causal)
        assert out.shape == (B, T, H, d)
        tol = FWD_TOL if dtype == "float32" else self.BF16_FWD_TOL
        assert np.abs(out - want).max() < tol
        assert not any(fa.LAUNCHES.values())

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d", [8, 16, 48, 80, 96, 128, 160, 256, 320, 512])
    def test_gradients(self, d, dtype, causal):
        q, k, v, kpm = padded_inputs(d, dtype, causal)
        _, grads = jax_reference(d, dtype, causal)
        for a, b in zip(torch_grads(q, k, v, kpm, causal, dtype), grads):
            assert a.shape == (B, T, H, d)
            if dtype == "float32":
                assert np.abs(a - b).max() < GRAD_TOL
            else:
                assert np.abs(a - b).max() <= self.BF16_GRAD_TOL * np.abs(b).max()


class TestHeadDimPad:
    """The pad rule that `flash_attention`, the emulation test and
    chip_smoke.py share."""

    def test_kernel_head_dim(self):
        assert [fa.kernel_head_dim(d) for d in (1, 8, 16, 31, 32, 33, 48, 63, 64)] == \
            [32] * 5 + [64] * 4
        assert [fa.kernel_head_dim(d) for d in (65, 80, 96, 127, 128)] == [128] * 5
        assert [fa.kernel_head_dim(d) for d in (129, 160, 200, 255, 256)] == [256] * 5
        # Above the widest template instance: the wide instances' widths,
        # 512 and then every multiple of 256.
        assert [fa.kernel_head_dim(d) for d in (257, 320, 400, 511, 512)] == [512] * 5
        assert [fa.kernel_head_dim(d) for d in (513, 600, 768, 769, 1024)] == \
            [768, 768, 768, 1024, 1024]
        assert all(fa.kernel_head_dim(d) in fa.KERNEL_HEAD_DIMS for d in range(1, 257))
        assert all(fa.kernel_head_dim(d) % fa.WIDE_SLICE == 0 for d in range(257, 2049))

    def test_pad_head_dim(self):
        x = torch.arange(2 * 3 * 5, dtype=torch.float32).view(2, 3, 5).transpose(0, 1)
        padded = fa.pad_head_dim(x, 32)
        assert padded.shape == (3, 2, 32) and padded.is_contiguous()
        assert torch.equal(padded[..., :5], x) and not padded[..., 5:].any()
        wide = torch.ones(2, 3, 96, dtype=torch.bfloat16)
        padded = fa.pad_head_dim(wide, fa.kernel_head_dim(96))
        assert padded.shape == (2, 3, 128) and padded.dtype == torch.bfloat16
        assert torch.equal(padded[..., :96], wide) and not padded[..., 96:].any()
        same = torch.zeros(2, 3, 32)
        assert fa.pad_head_dim(same, 32) is same

    def test_default_scale_is_the_unpadded_head_dims(self, d=16):
        rng = np.random.RandomState(9)
        q, k, v = (torch.from_numpy(x) for x in rand_qkv(rng, 1, 16, 2, d))
        out = fa.flash_attention(q, k, v, causal=True)
        assert torch.equal(out, fa.flash_attention(q, k, v, causal=True,
                                                   scale=1.0 / math.sqrt(d)))
        assert not torch.allclose(out, fa.flash_attention(
            q, k, v, causal=True, scale=1.0 / math.sqrt(fa.kernel_head_dim(d))))
        # The same as the plain forward at the unpadded width.
        bhtd = [x.transpose(1, 2).reshape(2, 16, d) for x in (q, k, v)]
        plain, _ = fa.attention_forward_plain(*bhtd, None, 2, 1.0 / math.sqrt(d), True)
        assert torch.allclose(out.transpose(1, 2).reshape(2, 16, d), plain, atol=1e-6)

    def test_default_scale_is_the_unpadded_head_dims_above_64(self):
        self.test_default_scale_is_the_unpadded_head_dims(d=96)
