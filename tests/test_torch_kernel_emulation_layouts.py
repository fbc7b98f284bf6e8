"""K1-K3 and the backward's delta kernel read and write their tensors in
place through strides: run on the CPU, emulated (`tests/cuda_emu`), each
instance on three layouts of the same numbers, with bit-identical outputs
across them and the plain versions' tolerances against the plain versions.

The layouts, each (B, H, T, D) views as the C entry points take them (base
and strides):
- packed: (BH, T, D) tensors, rows D apart;
- model: the model's (B, T, H, D) tensors transposed, rows H D apart, the
  way `flash_attention` hands them over;
- fused: q, k and v sliced out of one (B, T, 3, H, D) projection, rows 3 H
  D apart; out and dO out of another, dQ, dK and dV into a third.
The instances: the mma.sync K1-K3 in bf16 (the short tile at D = 64 and
256, K2's long one at D = 32) and in f32 (the short tile at D = 64 and
128, the long one at D = 32), the TMA-fed ones in bf16 (D = 64 and 256,
and K1 and K3 at D = 32 on 64-byte rows) and in f32 (D = 64 and 128),
whose tensor maps are 4-D over (d, t, h, b),
and the wide ones at D = 512 in both dtypes at both of K2's and K3's
tiles (two (batch, head) pairs a CTA at T = 17, the second of another
batch at H = 1). The delta kernel is held to its plain version at 1e-6 relative to the largest
row sum of |dO O| in both dtypes.
"""
import ctypes
import math
import os
import sys

import numpy as np
import pytest
import torch

from shockwave_tpu_torch.ops import flash_attention as fa

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_kernel_emulation import TOLS, _call, lib  # noqa: E402,F401 (a fixture)

LAYOUTS = ("packed", "model", "fused")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# (dtype, B, T, H, D, causal, mask) and the instances each case takes.
CASES = [
    ("bf16", 2, 24, 2, 64, True, "tail"),
    ("bf16", 2, 48, 2, 32, False, "tail"),
    ("bf16", 1, 20, 2, 256, True, None),
    ("bf16", 2, 65, 2, 64, True, "tail"),
    ("bf16", 1, 65, 2, 256, True, "key0"),
    ("f32", 2, 17, 2, 64, True, "tail"),
    ("f32", 1, 65, 2, 32, True, None),
    ("f32", 2, 17, 2, 128, False, "tail"),
    ("f32", 2, 65, 2, 64, True, "tail"),
    ("f32", 1, 65, 2, 128, True, "key0"),
    ("bf16", 1, 17, 2, 512, True, "key0"),
    ("bf16", 1, 40, 2, 512, False, "tail"),
    ("f32", 1, 17, 2, 512, True, "tail"),
    ("f32", 2, 40, 1, 512, True, None),
]
DELTA_TOL = 1e-6
ROWS = ("out", "lse", "dq", "dk", "dv")


OUTPUTS = ("out", "dq", "dk", "dv")


def _layouts(arrays, layout, dtype, outputs=OUTPUTS):
    """{name: (B, H, T, D) view in `dtype`} of the (B, H, T, D) numpy
    arrays in `layout`; the `outputs`' views are filled with NaN."""
    b, h, t, d = arrays["q"].shape
    views = {}
    if layout == "fused":
        for group in (("q", "k", "v"), ("out", "g"), ("dq", "dk", "dv")):
            buf = torch.empty(b, t, 3, h, d, dtype=dtype)
            for i, n in enumerate(group):
                views[n] = buf[:, :, i].transpose(1, 2)
    for n, x in arrays.items():
        x = torch.from_numpy(x).to(dtype)
        if layout == "packed":
            views[n] = x.contiguous()
        elif layout == "model":
            views[n] = x.transpose(1, 2).contiguous().transpose(1, 2)
        else:
            views[n].copy_(x)
        if n in outputs:
            views[n].fill_(math.nan)
    return views


def _run(lib, dtype, arrays, mask, heads, scale, causal, layout):
    """out, lse, dQ, dK and dV of the emulated K1-K3 on `layout` views of
    `arrays` (lse and delta packed), each as a packed (BH, T, D) copy."""
    b, h, t, d = arrays["q"].shape
    x = _layouts(arrays, layout, dtype)
    if layout != "packed":  # the views really are strided
        rows = (3 if layout == "fused" else 1) * h * d
        assert all(x[n].stride(2) == rows for n in x), layout
    lse = torch.full((b * h, t), math.nan)
    shape = dict(tq=t, tk=t, d=d, scale=scale, causal=causal)
    _call(lib, "flash_fwd", dtype, x["q"], x["k"], x["v"], mask, x["out"], lse, b * h, heads, t,
          t, **shape)
    delta = fa.attention_delta_plain(x["out"].reshape(b * h, t, d), x["g"].reshape(b * h, t, d))
    _call(lib, "flash_dq", dtype, x["q"], x["k"], x["v"], x["g"], lse, delta, mask, x["dq"],
          b * h, heads, t, t, **shape)
    _call(lib, "flash_dkv", dtype, x["q"], x["k"], x["v"], x["g"], lse, delta, mask, x["dk"],
          x["dv"], b * h, heads, t, t, **shape)
    got = {n: x[n].reshape(b * h, t, d) for n in OUTPUTS}
    got["lse"] = lse
    return got


@pytest.mark.parametrize("dt,b,t,h,d,causal,mask_kind", CASES)
def test_every_layout_gives_the_same_bits(lib, dt, b, t, h, d, causal, mask_kind):
    dtype = DTYPES[dt]
    rng = np.random.RandomState(t + d + b)
    arrays = {n: rng.randn(b, h, t, d).astype(np.float32)
              for n in ("q", "k", "v", "g", "out", "dq", "dk", "dv")}
    mask = None
    if mask_kind == "key0":
        mask = torch.ones(b, t, dtype=torch.bool)
        mask[:, 0] = False
    elif mask_kind == "tail":
        mask = torch.from_numpy(np.arange(t)[None, :] < rng.randint(t // 2, t + 1, (b, 1)))
    scale = 1.0 / math.sqrt(d)
    runs = {layout: _run(lib, dtype, arrays, mask, h, scale, causal, layout)
            for layout in LAYOUTS}
    for layout in LAYOUTS[1:]:
        for n in ROWS:
            assert torch.isfinite(runs[layout][n].float()).all(), (layout, n)
            assert torch.equal(runs[layout][n], runs["packed"][n]), (layout, n)

    # The packed run against the plain versions (the delta the kernels
    # read is the plain one of the kernel's own output, as in the JAX
    # package's backward).
    q, k, v, g = (torch.from_numpy(arrays[n]).reshape(b * h, t, d).to(dtype)
                  for n in ("q", "k", "v", "g"))
    got = runs["packed"]
    out_p, lse_p = fa.attention_forward_plain(q, k, v, mask, h, scale, causal)
    keys = (mask if mask is not None else torch.ones(b, t, dtype=torch.bool))
    rows = torch.cumsum(keys.repeat_interleave(h, dim=0).int(), 1) > 0
    if not causal:
        rows = keys.repeat_interleave(h, dim=0).any(1, keepdim=True).expand(-1, t)
    out_tol, lse_tol, grad_tol = TOLS[dtype]
    assert float((got["out"].float() - out_p.float()).abs()[rows].max()) <= out_tol
    assert float((got["lse"] - lse_p).abs()[rows].max()) <= lse_tol
    delta = (got["out"].float() * g.float()).sum(-1)
    bwd = (q, k, v, g, got["lse"], delta, mask, h, scale, causal)
    dq_p = fa.attention_dq_plain(*bwd)
    dk_p, dv_p = fa.attention_dkv_plain(*bwd)
    for n, want in (("dq", dq_p), ("dk", dk_p), ("dv", dv_p)):
        err = (got[n].float() - want.float()).abs().max() / want.float().abs().max()
        assert float(err) <= grad_tol, n
    assert lib.emu_shared_overruns() == 0


def test_the_cases_reach_every_strided_instance():
    """The cases take every instance of K1-K3: the mma.sync ones at both
    tiles in each dtype (bf16 K1 and K3 at the short one: their long tile
    is TMA-fed at every head dim), the TMA-fed ones (bf16 K1 and K3 at D =
    32 too), the wide ones at both tiles."""
    reached = {fa.instance(k, DTYPES[c[0]], c[4], c[2], c[2]) for c in CASES for k in fa.KERNELS}
    assert set(fa.INSTANCES) | set(fa.TMA_INSTANCES) | set(fa.WIDE_INSTANCES) == reached
    for name in fa.WIDE_INSTANCES:
        dtype = torch.float32 if name.endswith("_f32") else torch.bfloat16
        assert {fa.launch_config(c[2], c[2], 512, name) for c in CASES
                if DTYPES[c[0]] == dtype and c[4] == 512} == set(fa.WIDE_TILES[name][:2])
    tiles = {(fa.instance(k, DTYPES[c[0]], c[4], c[2], c[2]),
              fa.launch_config(c[2], c[2], c[4], fa.instance(k, DTYPES[c[0]], c[4], c[2], c[2])))
             for c in CASES for k in fa.KERNELS}
    for name in fa.INSTANCES:
        long = fa.KERNEL_TILES[name, 32][1]
        assert {tile for n, tile in tiles if n == name} == {
            min(fa.KERNEL_TILES[name, d][0] for d in fa.KERNEL_HEAD_DIMS)} | (
            {long} if fa.tile_instance(name, 32, long) == name else set()), name
    assert {("flash_fwd" + fa.TMA, 128), ("flash_dkv" + fa.TMA, 128)} <= {
        (fa.instance(k, torch.bfloat16, 32, c[2], c[2]), 128) for c in CASES
        if c[0] == "bf16" and c[4] == 32 for k in fa.KERNELS}


def test_tma_maps_are_four_dimensional(lib):
    """Every tensor map the TMA-fed instances encode is rank 4, over (d, t,
    h, b), in both dtypes."""
    lib.emu_tensor_map_ranks.restype = ctypes.c_uint
    lib.emu_tensor_map_ranks()
    for dt in DTYPES:
        rng = np.random.RandomState(3)
        arrays = {n: rng.randn(2, 2, 65, 64).astype(np.float32)
                  for n in ("q", "k", "v", "g", "out", "dq", "dk", "dv")}
        _run(lib, DTYPES[dt], arrays, None, 2, 0.125, True, "model")
        assert lib.emu_tensor_map_ranks() == 1 << 4, dt


@pytest.mark.parametrize("dtype,d,t", [(torch.bfloat16, 64, 40), (torch.float32, 64, 40),
                                       (torch.bfloat16, 32, 40), (torch.bfloat16, 64, 80),
                                       (torch.float32, 512, 17)])
def test_views_the_kernels_cannot_address_are_refused(lib, dtype, d, t):
    """A row stride that is not a multiple of 16 bytes, and rows that span
    2^31 elements (the kernels' row offsets are 32-bit), return
    cudaErrorInvalidValue (1) from K1's entry point (mma.sync, TMA-fed and
    wide instances); nothing is written. The wrapper copies such views."""
    b, h = 1, 2
    base = torch.randn(b, h, t, d + 1).to(dtype)
    misaligned = base[..., :d]  # rows d + 1 elements apart
    assert not fa._fits(misaligned)
    # Rows 8 ceil(2^31 / 8 t) elements apart (16-byte aligned): t of them
    # pass 2^31. No tensor holds them; the entry refuses before any read.
    far = fa._build.View(base.data_ptr(), fa._build.Strides(0, 16, 8 * -(-2**31 // (8 * t))))
    out, lse = torch.zeros(b, h, t, d, dtype=dtype), torch.zeros(b * h, t)
    name = fa.instance("flash_fwd", dtype, d, t, t)
    for q in (fa._view(misaligned), far):
        rc = getattr(lib, "swt_" + name.removesuffix(fa.TMA))(
            q, q, q, None, fa._view(out), lse.data_ptr(), b * h, h, t, t, d,
            fa.launch_config(t, t, d, name), 0.125, 1, 0, None)
        assert rc == 1 and not out.any(), name


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,t,h,d", [(2, 33, 2, 64), (1, 40, 3, 32), (2, 17, 2, 256),
                                     (1, 9, 2, 512)])
def test_delta_kernel_matches_the_plain_version(lib, dt, b, t, h, d):
    """delta = rowsum(dO O) in f32 from the emulated flash_bwd_delta: the
    same bits on the three layouts, and within 1e-6 of the plain version
    relative to the largest row sum of |dO O| (the f32 sums differ only in
    their order)."""
    dtype = DTYPES[dt]
    rng = np.random.RandomState(b + t + h + d)
    arrays = {n: rng.randn(b, h, t, d).astype(np.float32)
              for n in ("q", "k", "v", "g", "out", "dq", "dk", "dv")}
    entry = getattr(lib, "swt_" + fa.DELTA + fa.KERNEL_DTYPES[dtype])
    got = {}
    for layout in LAYOUTS:
        x = _layouts(arrays, layout, dtype, outputs=())
        delta = torch.full((b * h, t), math.nan)
        assert entry(fa._view(x["out"]), fa._view(x["g"]), delta.data_ptr(), b * h, h, t, d, 0,
                     None) == 0
        got[layout] = delta
    out = torch.from_numpy(arrays["out"]).to(dtype)
    g = torch.from_numpy(arrays["g"]).to(dtype)
    want = fa.attention_delta_plain(out, g).reshape(b * h, t)
    scale = float((out.float() * g.float()).abs().sum(-1).max())
    for layout in LAYOUTS:
        assert torch.equal(got[layout], got["packed"]), layout
    assert float((got["packed"] - want).abs().max()) <= DELTA_TOL * scale
