"""The wide instances of K1-K3, all on wgmma, run on the CPU, emulated
(`tests/cuda_emu`), against the plain versions: K1's (`flash_fwd_wide`,
bf16 and f32 as 3xTF32) and K2's and K3's in both dtypes
(`flash_dq_wide`, `flash_dkv_wide`, `flash_dq_wide_f32`,
`flash_dkv_wide_f32`: two warpgroups over 64-row tiles, or 32 rows of
each of two (batch, head) pairs up to T = 32;
`csrc/flash_attention_wide.cu`); the tensor-core multiply-adds they
issue, counted by the emulator; and the emulated wgmma, in the layouts the
kernels give it, against a plain matmul.

The wide cases cover the row that sees no key, ragged ends at T = 17 and
T = 100 (two q- and k-tiles), Tq != Tk key-padded at both tiles of K2 and
K3 (the short one with a missing pair at BH = 3), D = 768 (a 512- and a
256-column slice; f32 K1 and bf16 K2 and K3 stream their A operands
there, K3 runs three slices) and D = 1280 (bf16 K1 streams Q), all at T
<= 128. Tolerances are the other emulation files' (`TOLS`); K2 and K3
hold the plain versions to them, and key 0's gradients to exactly 0,
through `test_torch_kernel_emulation.check_kernels`.
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
from test_torch_kernel_emulation import (TOLS, _call, check_kernels,  # noqa: E402
                                         lib)  # noqa: F401 (a fixture)

import emulate  # noqa: E402  (tests/cuda_emu, on the path through the import above)

# (B, Tq, Tk, H, D, causal, mask), run in bf16 and in f32.
WIDE_CASES = [
    (1, 17, 17, 1, 512, True, "key0"),
    (2, 17, 17, 2, 512, True, "tail"),
    (1, 100, 100, 2, 512, True, "tail"),
    (2, 40, 72, 1, 512, False, "tail"),
    (1, 40, 40, 1, 768, True, "tail"),
    (1, 17, 17, 1, 1280, True, "key0"),
    (3, 24, 32, 1, 512, False, "tail"),
]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _forward(lib, dtype, b, tq, tk, h, d, causal, mask_kind, seed):
    """(out, lse) of the emulated K1 wide and of the plain version, the
    rows that see a key, on inputs made from `seed`."""
    rng = np.random.RandomState(seed)
    bh, scale = b * h, 1.0 / math.sqrt(d)
    q = torch.from_numpy(rng.randn(bh, tq, d).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.randn(bh, tk, d).astype(np.float32)).to(dtype)
            for _ in range(2))
    mask = None
    if mask_kind == "key0":
        mask = torch.ones(b, tk, dtype=torch.bool)
        mask[:, 0] = False
    elif mask_kind == "tail":
        mask = torch.from_numpy(np.arange(tk)[None, :] < rng.randint(tk // 2, tk + 1, (b, 1)))
    out, lse = torch.full_like(q, math.nan), torch.full((bh, tq), math.nan)
    _call(lib, "flash_fwd", dtype, q, k, v, mask, out, lse, bh, h, tq, tk,
          tq=tq, tk=tk, d=d, scale=scale, causal=causal)
    out_p, lse_p = fa.attention_forward_plain(q, k, v, mask, h, scale, causal)
    keys = (mask if mask is not None else torch.ones(b, tk, dtype=torch.bool))
    keys = keys.repeat_interleave(h, dim=0)
    rows = ((torch.cumsum(keys.int(), 1) > 0)[:, :tq] if causal
            else keys.any(1, keepdim=True).expand(-1, tq))
    return out, lse, out_p, lse_p, rows


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", WIDE_CASES)
def test_k1_wide_matches_the_plain_version(lib, dt, b, tq, tk, h, d, causal, mask_kind):
    dtype = DTYPES[dt]
    out, lse, out_p, lse_p, rows = _forward(lib, dtype, b, tq, tk, h, d, causal, mask_kind,
                                            seed=tq + tk + d)
    out_tol, lse_tol, _ = TOLS[dtype]
    assert torch.isfinite(out).all()
    assert float((out.float() - out_p.float()).abs()[rows].max()) <= out_tol
    assert float((lse - lse_p).abs()[rows].max()) <= lse_tol
    assert lib.emu_shared_overruns() == 0


def test_the_wide_cases_reach_every_path():
    """64-row tiles of K1 in both dtypes, two of them at T = 100, one and
    two slices past the first, and Q resident and streamed in each dtype
    (`fwd_wide_q_resident`: bf16 up to D = 1024, f32 up to 512); both
    tiles of K2 and K3 in both dtypes, the short one with the row that
    sees no key, with a missing pair (BH odd) and at Tq != Tk; bf16 K2's
    and K3's three instances (`bwd_wide_bf16_resident`: the A tiles stay
    at the 64-row tile at D = 512, and stream at the 32-row tile and at D
    >= 768)."""
    for name in ("flash_fwd_wide", "flash_fwd_wide_f32"):
        assert fa.WIDE_TILES[name][:2] == (64, 64)
    for name in ("flash_dq_wide_f32", "flash_dkv_wide_f32", "flash_dq_wide", "flash_dkv_wide"):
        tiles = {fa.launch_config(c[1], c[2], 512, name): c for c in WIDE_CASES}
        assert set(tiles) == {32, 64}
        short = [c for c in WIDE_CASES if fa.launch_config(c[1], c[2], 512, name) == 32]
        assert any(c[6] == "key0" and c[5] for c in short)
        assert any(c[0] * c[3] % 2 and c[1] != c[2] for c in short)
    widths = {c[4] for c in WIDE_CASES}
    assert {512, 768, 1280} <= widths and max(c[1] for c in WIDE_CASES) == 100
    assert any(-(-d // 512) == 2 and d % 512 for d in widths)  # a 256-column last slice
    bf16_streams = {d > 1024 for d in widths}
    f32_streams = {d > 512 for d in widths}  # f32 K1's Q, bf16 K2's and K3's A tiles
    assert bf16_streams == f32_streams == {True, False}
    assert {c[6] for c in WIDE_CASES} == {"key0", "tail"}
    assert any(c[1] != c[2] for c in WIDE_CASES)
    for name in ("flash_dq_wide", "flash_dkv_wide"):
        instances = {(tile, tile == 64 and c[4] == 512)
                     for c in WIDE_CASES for tile in [fa.launch_config(c[1], c[2], c[4], name)]}
        assert instances == {(64, True), (64, False), (32, False)}


@pytest.mark.parametrize("dt", DTYPES)
def test_k1_wide_forms_the_scores_once_per_row_tile(lib, dt):
    """The emulator counts the tensor-core multiply-adds of a launch. At D
    = 512 K1 wide issues exactly S + P.V for its 64-row tiles (each product
    three times in f32, 3xTF32): S = 64 x 64 x D and P.V = 64 x 64 x D per
    (row tile, k-tile); the first wide design issued 4 S + P.V there. At D
    = 768 the second slice (256 columns) forms S once more."""
    dtype, times = DTYPES[dt], 3 if dt == "f32" else 1
    tiles = 2 * 2  # T = 128, not causal: 2 row tiles x 2 k-tiles
    lib.emu_tensor_products.restype = ctypes.c_long
    for d, slices in ((512, (512,)), (768, (512, 256))):
        _forward(lib, dtype, 1, 128, 128, 1, d, False, None, seed=d)
        scores, pv = 64 * 64 * d, 64 * 64 * sum(slices)
        assert lib.emu_tensor_products() == times * tiles * (len(slices) * scores + pv), d
        if d == 512:
            assert lib.emu_tensor_products() == times * tiles * 2 * 64 * 64 * d


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", WIDE_CASES)
def test_k2_k3_wide_f32_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    """f32 K1, K2 and K3 wide on the same inputs, each held against its
    plain version (K2 and K3 on the plain lse and delta) at F32_TOL; key
    0's gradients exactly 0; no copy past shared memory."""
    check_kernels(lib, torch.float32, b, tq, tk, h, d, causal, mask_kind)


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", WIDE_CASES)
def test_k2_k3_wide_bf16_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    """bf16 K1, K2 and K3 wide on the same inputs, each held against its
    plain version (K2 and K3 on the plain lse and delta) at the bf16
    tolerances; key 0's gradients exactly 0; no copy past shared memory.
    K2 and K3 keep their A tiles in shared memory at D = 512 and stream
    them at D = 768 and 1280."""
    check_kernels(lib, torch.bfloat16, b, tq, tk, h, d, causal, mask_kind)


def _backward_products(lib, dtype, d):
    """The tensor-core multiply-adds of one K2 and one K3 launch at T = 128
    not causal (2 x 2 (q-tile, k-tile) pairs of 64 rows), on inputs made
    from a seed."""
    rng = np.random.RandomState(d)
    t, bh = 128, 1
    q, k, v, g = (torch.from_numpy(rng.randn(bh, t, d).astype(np.float32)).to(dtype)
                  for _ in range(4))
    lse, delta = torch.zeros(bh, t), torch.zeros(bh, t)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    shape = dict(tq=t, tk=t, d=d, scale=1.0 / math.sqrt(d), causal=False)
    lib.emu_tensor_products.restype = ctypes.c_long
    _call(lib, "flash_dq", dtype, q, k, v, g, lse, delta, None, dq, bh, 1, t, t,
          **shape)
    dq_products = lib.emu_tensor_products()
    _call(lib, "flash_dkv", dtype, q, k, v, g, lse, delta, None, dk, dv, bh, 1,
          t, t, **shape)
    return dq_products, lib.emu_tensor_products()


@pytest.mark.parametrize("d,slices", [(512, (512,)), (768, (512, 256))])
def test_k2_k3_wide_bf16_form_each_score_tile_once_per_cta(lib, d, slices):
    """As the f32 pair, in bf16 (one product each): per (q-tile, k-tile)
    pair K2 forms S + dP + dQ at D = 512, S and dP once per CTA of up to
    512 dQ columns, and K3 2 (S^T + dP^T) + dV + dK, S^T and dP^T once per
    CTA of 256 dK and dV columns; the first bf16 design formed each score
    tile 4 times at D = 512. At D = 768 the A tiles stream (two chunks a
    score step) and the counts are the same per CTA."""
    unit = 2 * 2 * 64 * 64  # (q-tile, k-tile) pairs x a 64 x 64 tile
    dq_products, dkv_products = _backward_products(lib, torch.bfloat16, d)
    assert dq_products == unit * (len(slices) * 2 * d + d)
    assert dkv_products == unit * (d // 256 * 2 * d + 2 * d)
    if d == 512:
        assert (dq_products, dkv_products) == (unit * 3 * d, unit * 6 * d)


@pytest.mark.parametrize("d,slices", [(512, (512,)), (768, (512, 256))])
def test_k2_k3_wide_f32_form_each_score_tile_once_per_cta(lib, d, slices):
    """The tensor-core multiply-adds of one launch, at T = 128 not causal
    (2 x 2 (q-tile, k-tile) pairs of 64 rows), as 3xTF32 (three products
    each). K2 (CTAs of up to 512 dQ columns): S and dP once per CTA and dQ
    over its columns, so 3 (S + dP + dQ) at D = 512 and S and dP twice at
    D = 768. K3 (CTAs of 256 dK and dV columns): S^T and dP^T once per
    CTA, 3 (2 (S^T + dP^T) + dV + dK) at D = 512 and three times at D =
    768. The first wide design formed each score tile 4 times at D = 512."""
    unit = 3 * 2 * 2 * 64 * 64  # 3xTF32 x (q-tile, k-tile) pairs x a 64 x 64 tile
    dq_products, dkv_products = _backward_products(lib, torch.float32, d)
    assert dq_products == unit * (len(slices) * 2 * d + d)
    assert dkv_products == unit * (d // 256 * 2 * d + 2 * d)
    if d == 512:
        assert dkv_products == unit * 6 * d


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    if emulate.compiler() is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = str(tmp_path_factory.mktemp("wgmma_probe"))
    path = emulate.build(out, sources=(os.path.join(emulate.HERE, "wgmma_probe.cu"),),
                         name="libwgmma_probe.so")
    probe = ctypes.CDLL(path)
    for name in ("swt_wgmma_probe_bf16", "swt_wgmma_probe_f32"):
        getattr(probe, name).argtypes = [ctypes.c_void_p] * 5
    return probe


@pytest.mark.parametrize("dt", DTYPES)
def test_emulated_wgmma_is_a_matmul_in_the_kernels_layouts(probe, dt):
    """S = A . B^T through the kernel's score step (bf16: A and B K-major
    through descriptors, 128-byte swizzle; f32: A split in registers, B's
    big and small planes) and O = P . V through its P.V step (bf16: P from
    registers, V MN-major; f32: V staged transposed with P's key order),
    against the same products in float64 (P: the probe's S in the
    kernel's dtype, rounded to bf16 in bf16 as the kernel rounds it), to
    1e-5 of the largest entry: exact products summed in f32 in bf16,
    3xTF32's about 21 bits in f32."""
    dtype = DTYPES[dt]
    cols = 64 if dt == "bf16" else 32
    rng = np.random.RandomState(7)
    a, b, v = (torch.from_numpy(rng.randn(64, cols).astype(np.float32)).to(dtype)
               for _ in range(3))
    s = torch.full((64, 64), math.nan)
    o = torch.full((64, cols), math.nan)
    getattr(probe, f"swt_wgmma_probe_{dt}")(*(t.data_ptr() for t in (a, b, v, s, o)))
    s_want = a.double() @ b.double().T
    o_want = s.to(dtype).double() @ v.double()  # P: the probe's own S, in the kernel's dtype
    for got, want in ((s, s_want), (o, o_want)):
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
