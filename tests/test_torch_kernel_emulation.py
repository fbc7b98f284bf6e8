"""The kernels' CUDA source, run on the CPU, against the plain versions.

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
def lib(tmp_path_factory):
    if emulate.compiler() is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    lib = ctypes.CDLL(emulate.build(str(tmp_path_factory.mktemp("cuda_emu"))))
    for name, argtypes in _build._ENTRY_POINTS:
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.emu_shared_overruns.restype = ctypes.c_long
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield lib
    torch.set_num_threads(threads)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(lib, kernel, dtype, *args, tq, tk, d, scale, causal):
    """swt_<kernel><suffix>(*args, ..., d, tile, scale, causal, device,
    stream) of the instance for `dtype`."""
    name = kernel + fa.KERNEL_DTYPES[dtype]
    tile = fa.launch_config(tq, tk, d, name)
    rc = getattr(lib, f"swt_{name}")(*args, d, tile, scale, int(causal), 0, None)
    assert rc == 0, (name, tile, rc)


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
# d = 96 to 128 (the long tile, key-padded).
PADDED_CASES = [
    (2, 64, 64, 2, 16, True, "tail"),
    (1, 32, 80, 2, 48, False, "tail"),
    (1, 96, 96, 1, 48, True, "key0"),
    (1, 72, 72, 1, 96, False, "tail"),
]
# The bf16 instances: both tiles (32 up to T = 32, 64 beyond) at every
# head dim, ragged ends, Tq != Tk, the row that sees no key at each tile,
# and d = 96 padded to 128; at D = 256 the short tile with the row that
# sees no key, the long tile at Tq != Tk, and d = 200 padded to 256 with
# the row that sees no key at the long tile.
BF16_CASES = [
    (1, 32, 32, 1, 256, True, "key0"),
    (1, 24, 40, 1, 256, False, "tail"),
    (1, 40, 40, 1, 200, True, "key0"),
    (2, 17, 17, 2, 128, True, "tail"),
    (1, 40, 72, 1, 128, False, "key0"),
    (1, 65, 65, 1, 128, True, "tail"),
    (2, 32, 32, 2, 64, True, "key0"),
    (1, 48, 48, 2, 64, False, "tail"),
    (2, 24, 24, 2, 32, True, "tail"),
    (1, 33, 64, 1, 32, False, None),
    (1, 72, 72, 1, 96, True, "key0"),
]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", CASES + PADDED_CASES)
def test_f32_kernels_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    check_kernels(lib, torch.float32, b, tq, tk, h, d, causal, mask_kind)


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", BF16_CASES)
def test_bf16_kernels_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    check_kernels(lib, torch.bfloat16, b, tq, tk, h, d, causal, mask_kind)


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
    _call(lib, "flash_fwd", dtype, *map(_ptr, (qw, kw, vw, mask, out, lse)), bh, h, tq, tk,
          **shape)
    out_p, lse_p = fa.attention_forward_plain(q, k, v, mask, h, scale, causal)
    delta = (out_p.float() * g.float()).sum(-1)
    dq = torch.full_like(qw, math.nan)
    _call(lib, "flash_dq", dtype, *map(_ptr, (qw, kw, vw, gw, lse_p, delta, mask, dq)), bh, h,
          tq, tk, **shape)
    dk, dv = torch.full_like(kw, math.nan), torch.full_like(vw, math.nan)
    _call(lib, "flash_dkv", dtype, *map(_ptr, (qw, kw, vw, gw, lse_p, delta, mask, dk, dv)), bh,
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
    return {(fa.launch_config(tq, tk, fa.kernel_head_dim(d), name), fa.kernel_head_dim(d))
            for _, tq, tk, _, d, _, _ in cases}


def test_every_f32_tile_is_emulated():
    """The cases reach both tiles of each f32 instance at every head dim,
    and so do the padded cases at their padded widths."""
    for kernel in fa.KERNELS:
        name = kernel + "_f32"
        assert _reached(CASES, name) == {(tile, d) for d in fa.KERNEL_HEAD_DIMS
                                         for tile in fa.KERNEL_TILES[name, d][:2]}, name
        assert _reached(PADDED_CASES, name) == {(16, 32), (64, 64), (64, 128)}, name


def test_every_bf16_tile_is_emulated():
    """The bf16 cases reach both tiles of each bf16 instance at every head
    dim, the row that sees no key at both tiles (at D = 256 too), and
    d = 96 and 200 padded."""
    for name in fa.KERNELS:
        assert _reached(BF16_CASES, name) == {(tile, d) for d in fa.KERNEL_HEAD_DIMS
                                              for tile in fa.KERNEL_TILES[name, d][:2]}, name
        for widths in (fa.KERNEL_HEAD_DIMS, (256,)):
            assert {fa.launch_config(c[1], c[2], fa.kernel_head_dim(c[4]), name)
                    for c in BF16_CASES if c[6] == "key0"
                    and fa.kernel_head_dim(c[4]) in widths} == set(fa.KERNEL_TILES[name, 256][:2])
    assert {fa.kernel_head_dim(d) for _, _, _, _, d, _, _ in BF16_CASES
            if d not in fa.KERNEL_HEAD_DIMS} == {128, 256}
