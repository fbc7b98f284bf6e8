"""The kernels' CUDA source, run on the CPU, against the plain versions
(the f32 instances here, the bf16 ones in
`test_torch_kernel_emulation_bf16.py`, which shares this module's
emulated library, checks and tolerances).

`tests/cuda_emu` compiles `shockwave_tpu_torch/csrc/flash_attention.cu`
with the host C++ compiler: every CUDA thread of a CTA is a host thread,
`__syncthreads` and the warp's shuffles are barriers, `ldmatrix` and
`mma.sync` (m16n8k16 on bf16, m16n8k8 on TF32) are computed from the 32
lanes' fragments as the PTX ISA lays them out, and `cp.async` copies at
once. The C entry points are called as the wrappers call them on the
card, with `launch_config`'s tile for each instance, on CPU tensors made
from a seed with numpy, padded as `flash_attention` pads them (head dims
16, 48, 96 and 200 too) and sliced back. The tolerances are chip_smoke.py's:
in f32 F32_TOL (1e-4 abs on out and lse, 1e-4 relative to the largest
entry on dQ, dK and dV); in bf16 2e-2 abs on out, 1e-3 on lse and 5e-2
relative on the gradients (p and dS are rounded to bf16 in both, in
other places). A wrong fragment index or mask gives errors of order 1.
What the card alone shows (timing, the tensor cores' rounding, a copy
that races its use) stays with chip_smoke.py.
"""
import ctypes
import math
import os
import sys

import numpy as np
import pytest
import torch

from shockwave_tpu_torch.ops import _build
from shockwave_tpu_torch.ops import flash_attention as fa

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu"))
import emulate  # noqa: E402

F32_TOL = 1e-4
# (out, lse, dQ/dK/dV relative) by dtype.
TOLS = {torch.float32: (F32_TOL, F32_TOL, F32_TOL), torch.bfloat16: (2e-2, 1e-3, 5e-2)}


@pytest.fixture(scope="module")
def lib():
    if emulate.compiler() is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    lib = ctypes.CDLL(emulate.cached_build())
    for name, argtypes in _build._ENTRY_POINTS:
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.emu_shared_overruns.restype = ctypes.c_long
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield lib
    torch.set_num_threads(threads)


def _arg(t, heads):
    """What a C entry point takes for `t`: the View of a packed (BH, T, D)
    tensor or of a (B, H, T, D) view, the base of a mask, lse or delta, or
    `t` itself (None, an int)."""
    if not isinstance(t, torch.Tensor):
        return t
    return fa._view(fa._as_bhtd(t, heads)) if t.dim() >= 3 else t.data_ptr()


def _call(lib, kernel, dtype, *args, tq, tk, d, scale, causal):
    """swt_<instance>(*args, ..., d, tile, scale, causal, device, stream)
    of `kernel`'s instance for `dtype`, d and the lengths (the wide one
    above 256; a TMA-fed one through its base instance's entry point), as
    the wrapper calls it: `args` are the entry's tensors (q, k, v, ...,
    each packed (BH, T, D) or a (B, H, T, D) view), then bh, heads, tq and
    tk. Returns the instance's name."""
    heads = args[-3]
    name = fa.instance(kernel, dtype, d, tq, tk)
    tile = fa.launch_config(tq, tk, d, name)
    rc = getattr(lib, "swt_" + name.removesuffix(fa.TMA))(
        *(_arg(t, heads) for t in args), d, tile, scale, int(causal), 0, None)
    assert rc == 0, (name, tile, rc)
    return name


# (B, Tq, Tk, H, D, causal, mask): both tiles of every f32 instance, ragged
# ends inside and one past the one-warp tile, Tq != Tk, every head dim, and
# a row that sees no key.
CASES = [
    (2, 17, 17, 2, 64, True, "tail"),
    (2, 32, 32, 2, 32, False, "tail"),
    (1, 48, 48, 2, 32, True, "key0"),
    (1, 65, 65, 1, 64, True, "tail"),
    (1, 32, 80, 2, 32, False, None),
    (1, 128, 128, 1, 64, True, "key0"),
    (2, 24, 24, 1, 128, True, "tail"),
    (1, 40, 72, 1, 128, False, "key0"),
    # D = 256: the one-warp tile causal with the row that sees no key, the
    # 32-row long tile (Tq != Tk, key-padded; K3's two warps per 16 keys).
    (1, 17, 17, 1, 256, True, "key0"),
    (1, 8, 65, 1, 256, False, "tail"),
]
# The same at head dims the kernels are not built for: d = 16 pads to 32
# (the one-warp tile; the d = 16 decoder's causal shape), d = 48 to 64
# (the long tile, key-padded and Tq != Tk, and the row that sees no key),
# d = 96 to 128 (the long tile, key-padded), and d = 320 to 512, the wide
# f32 instances: T = 17 reaches both of their 16-row tiles (the second
# ragged) and both 256-column slices, with the row that sees no key.
PADDED_CASES = [
    (2, 64, 64, 2, 16, True, "tail"),
    (1, 32, 80, 2, 48, False, "tail"),
    (1, 96, 96, 1, 48, True, "key0"),
    (1, 72, 72, 1, 96, False, "tail"),
    (1, 17, 17, 1, 320, True, "key0"),
]
@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", CASES + PADDED_CASES)
def test_f32_kernels_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    check_kernels(lib, torch.float32, b, tq, tk, h, d, causal, mask_kind)


def check_kernels(lib, dtype, b, tq, tk, h, d, causal, mask_kind):
    """q, k, v and dO go in padded through the port's own `pad_head_dim`
    to `kernel_head_dim(d)` (d itself at 32, 64, 128 and 256), the entry points
    run at that width, and the outputs, sliced back to d, are held against
    the plain versions at d; the padded columns come out exactly 0."""
    rng = np.random.RandomState(tq + tk + d)
    bh, scale = b * h, 1.0 / math.sqrt(d)
    width = fa.kernel_head_dim(d)
    q, g = (torch.from_numpy(rng.randn(bh, tq, d).astype(np.float32)).to(dtype)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(bh, tk, d).astype(np.float32)).to(dtype)
            for _ in range(2))
    mask = None
    if mask_kind == "key0":
        mask = torch.ones(b, tk, dtype=torch.bool)
        mask[:, 0] = False
    elif mask_kind == "tail":
        mask = torch.from_numpy(np.arange(tk)[None, :] < rng.randint(tk // 2, tk + 1, (b, 1)))
    shape = dict(tq=tq, tk=tk, d=width, scale=scale, causal=causal)
    qw, kw, vw, gw = (fa.pad_head_dim(x, width) for x in (q, k, v, g))

    out, lse = torch.full_like(qw, math.nan), torch.full((bh, tq), math.nan)
    _call(lib, "flash_fwd", dtype, qw, kw, vw, mask, out, lse, bh, h, tq, tk,
          **shape)
    out_p, lse_p = fa.attention_forward_plain(q, k, v, mask, h, scale, causal)
    delta = (out_p.float() * g.float()).sum(-1)
    dq = torch.full_like(qw, math.nan)
    _call(lib, "flash_dq", dtype, qw, kw, vw, gw, lse_p, delta, mask, dq, bh, h,
          tq, tk, **shape)
    dk, dv = torch.full_like(kw, math.nan), torch.full_like(vw, math.nan)
    _call(lib, "flash_dkv", dtype, qw, kw, vw, gw, lse_p, delta, mask, dk, dv, bh,
          h, tq, tk, **shape)
    bwd = (q, k, v, g, lse_p, delta, mask)
    dq_p = fa.attention_dq_plain(*bwd, h, scale, causal)
    dk_p, dv_p = fa.attention_dkv_plain(*bwd, h, scale, causal)

    # Rows that see a key (a row that sees none is a uniform average whose
    # extent depends on the tiling, as in the JAX package).
    keys = (mask if mask is not None else torch.ones(b, tk, dtype=torch.bool))
    keys = keys.repeat_interleave(h, dim=0)
    rows = ((torch.cumsum(keys.int(), 1) > 0)[:, :tq] if causal
            else keys.any(1, keepdim=True).expand(-1, tq))
    out_tol, lse_tol, grad_tol = TOLS[dtype]
    for t in (out, dq, dk, dv):
        assert torch.isfinite(t).all() and not t[..., d:].any()
    assert float((out[..., :d].float() - out_p.float()).abs()[rows].max()) <= out_tol
    assert float((lse - lse_p).abs()[rows].max()) <= lse_tol
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        err = (got[..., :d].float() - want.float()).abs().max()
        assert float(err / want.float().abs().max()) <= grad_tol
    if mask_kind == "key0":  # the masked key, and the causal row that sees no key,
        for t in (dq, dk, dv) if causal else (dk, dv):  # leak no gradient
            assert float(t[:, 0].abs().max()) == 0.0
    assert lib.emu_shared_overruns() == 0


def _reached(cases, name):
    """{(tile, width)} of instance `name` over the cases of its widths."""
    wide = name in fa.WIDE_INSTANCES
    return {(fa.launch_config(tq, tk, fa.kernel_head_dim(d), name), fa.kernel_head_dim(d))
            for _, tq, tk, _, d, _, _ in cases
            if (fa.kernel_head_dim(d) > fa.KERNEL_HEAD_DIMS[-1]) == wide}


def test_every_f32_tile_is_emulated():
    """The cases reach both tiles of each f32 instance at every head dim,
    and so do the padded cases at their padded widths."""
    for kernel in fa.KERNELS:
        name = kernel + "_f32"
        assert _reached(CASES, name) == {(tile, d) for d in fa.KERNEL_HEAD_DIMS
                                         for tile in fa.KERNEL_TILES[name, d][:2]}, name
        assert _reached(PADDED_CASES, name) == {(16, 32), (64, 64), (64, 128)}, name
