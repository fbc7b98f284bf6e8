"""The TMA-fed K1-K3 in bf16 (`flash_fwd_tma`, `flash_dq_tma`,
`flash_dkv_tma`: `csrc/flash_attention_tma.cu`) run on the CPU, emulated
(`tests/cuda_emu`), against the plain versions, and the tensor-core
multiply-adds they issue.

The emulator runs each CUDA thread of a CTA as a host thread, so the
producer warp (TMA loads into the ring, the per-tile bias or lse and
delta, the "empty" waits) and the two consumer warpgroups (the "full"
waits, wgmma, the softmax or the gradient terms) run side by side; the
mbarriers keep their phases and transaction bytes, and TMA lands each box
in the 128-byte swizzle with zeros past the tensor's edges, as the PTX ISA
lays them out. The cases, at D = 64, 128 and 256 (the widths these
kernels take): causal at T = 65 and 130 (diagonal and off-diagonal tiles,
ragged ends), Tq != Tk key-padded, and the row and key that see nothing
(key 0 masked: its gradients exactly 0). Tolerances are the other
emulation files' (`TOLS`, chip_smoke.py's), through
`test_torch_kernel_emulation.check_kernels`.
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
from test_torch_kernel_emulation import TOLS, _call, _ptr, check_kernels, lib  # noqa: E402,F401

CASES = [(b, tq, tk, h, d, causal, mask)
         for d in fa.TMA_HEAD_DIMS
         for b, tq, tk, h, causal, mask in ((1, 65, 65, 1, True, "tail"),
                                             (1, 130, 130, 1, True, None),
                                             (2, 40, 96, 1, False, "tail"),
                                             (1, 72, 72, 2, True, "key0"))]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", CASES)
def test_tma_kernels_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    check_kernels(lib, torch.bfloat16, b, tq, tk, h, d, causal, mask_kind)


def test_the_cases_reach_the_tma_kernels_at_every_width():
    """Every case takes the three TMA instances; K1's and K2's T = 130 has
    a ragged second row tile and, at D = 128 and 256, several k-tiles per
    row tile on the diagonal; K3's T = 130 walks three q-tiles from its
    first key tile."""
    for b, tq, tk, h, d, causal, mask in CASES:
        for kernel in fa.KERNELS:
            name = fa.instance(kernel, torch.bfloat16, d, tq, tk)
            assert name == kernel + fa.TMA
            assert fa.launch_config(tq, tk, d, name) == fa.KERNEL_TILES[kernel, d][1]
    assert {c[4] for c in CASES} == set(fa.TMA_HEAD_DIMS)
    assert {c[6] for c in CASES} == {"tail", None, "key0"}
    assert any(c[1] != c[2] for c in CASES) and any(c[1] % 64 for c in CASES if c[5])


def _inputs(tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (torch.from_numpy(rng.randn(1, tq, d).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, tk, d).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, g


def _k1_pairs(tq, tk, d, causal):
    """K1's (row tile, key tile) pairs: 128 query rows a CTA, kN keys a
    tile (128, or 64 at D = 256), up to the causal diagonal."""
    rows, keys = 128, 64 if d == 256 else 128
    pairs = 0
    for q0 in range(0, tq, rows):
        nk = -(-tk // keys)
        pairs += min(nk, (q0 + rows - 1) // keys + 1) if causal else nk
    return rows, keys, pairs


def _k2_pairs(tq, tk, d, causal):
    """K2's (row tile, key tile) pairs: 128 query rows a CTA, kN keys a
    tile (128, 64 and 32 at D = 64, 128 and 256), up to the causal
    diagonal."""
    rows, keys = 128, {64: 128, 128: 64, 256: 32}[d]
    pairs = 0
    for q0 in range(0, tq, rows):
        nk = -(-tk // keys)
        pairs += min(nk, (q0 + rows - 1) // keys + 1) if causal else nk
    return rows, keys, pairs


def _k3_pairs(tq, tk, d, causal):
    """K3's (key tile, q-tile) pairs: kKeys keys a CTA (128, or 64 at D =
    256), 64 queries a tile, from the causal diagonal on."""
    keys = fa.KERNEL_TILES["flash_dkv", d][1]
    pairs = 0
    for k0 in range(0, tk, keys):
        pairs += -(-tq // 64) - (k0 // 64 if causal else 0)
    return keys, 64, pairs


@pytest.mark.parametrize("d", fa.TMA_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk,causal", [(130, 130, True), (40, 200, False)])
def test_each_product_is_formed_once_per_tile_pair(lib, d, tq, tk, causal):
    """The emulator's count of tensor-core multiply-adds of one launch: K1
    forms S and P.V once per (row tile, key tile) pair it visits (2 x rows
    x keys x D), K2 S, dP and dQ (3 x rows x keys x D), K3 forms S^T,
    dP^T, dV and dK once per (key tile, q-tile) pair (4 x keys x 64 x D),
    at D = 256 too, where its two groups split the four products between
    them."""
    lib.emu_tensor_products.restype = ctypes.c_long
    q, k, v, g = _inputs(tq, tk, d, tq + d)
    scale = 1.0 / math.sqrt(d)
    shape = dict(tq=tq, tk=tk, d=d, scale=scale, causal=causal)
    out, lse = torch.empty_like(q), torch.empty(1, tq)
    name = _call(lib, "flash_fwd", torch.bfloat16, *map(_ptr, (q, k, v, None, out, lse)), 1, 1,
                 tq, tk, **shape)
    assert name == "flash_fwd" + fa.TMA
    rows, keys, pairs = _k1_pairs(tq, tk, d, causal)
    assert lib.emu_tensor_products() == pairs * 2 * rows * keys * d
    delta = (out.float() * g.float()).sum(-1)
    dq = torch.empty_like(q)
    name = _call(lib, "flash_dq", torch.bfloat16, *map(_ptr, (q, k, v, g, lse, delta, None, dq)),
                 1, 1, tq, tk, **shape)
    assert name == "flash_dq" + fa.TMA
    rows, keys, pairs = _k2_pairs(tq, tk, d, causal)
    assert lib.emu_tensor_products() == pairs * 3 * rows * keys * d
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    name = _call(lib, "flash_dkv", torch.bfloat16,
                 *map(_ptr, (q, k, v, g, lse, delta, None, dk, dv)), 1, 1, tq, tk, **shape)
    assert name == "flash_dkv" + fa.TMA
    keys, queries, pairs = _k3_pairs(tq, tk, d, causal)
    assert lib.emu_tensor_products() == pairs * 4 * keys * queries * d
    for t in (out, dq, dk):
        assert torch.isfinite(t.float()).all()
    assert lib.emu_shared_overruns() == 0


@pytest.mark.parametrize("d", fa.TMA_HEAD_DIMS)
def test_a_row_that_sees_no_key_gets_zero_dq(lib, d):
    """dQ of every query row that sees no key is exactly 0 from the TMA-fed
    K2: the causal row 0 with key 0 masked, and every row of a batch whose
    keys are all masked (Tq != Tk, two k-tiles at every D); the other
    batch's dQ stays within the bf16 tolerance of the plain version."""
    b, tq, tk, h = 2, 65, 130, 2
    scale = 1.0 / math.sqrt(d)
    for causal, t_k in ((True, tq), (False, tk)):
        rng = np.random.RandomState(d + t_k)
        q, g = (torch.from_numpy(rng.randn(b * h, tq, d).astype(np.float32)).to(torch.bfloat16)
                for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(b * h, t_k, d).astype(np.float32)).to(torch.bfloat16)
                for _ in range(2))
        mask = torch.ones(b, t_k, dtype=torch.bool)
        if causal:
            mask[:, 0] = False
        else:
            mask[1] = False
        out, lse = fa.attention_forward_plain(q, k, v, mask, h, scale, causal)
        delta = (out.float() * g.float()).sum(-1)
        dq = torch.full_like(q, math.nan)
        name = _call(lib, "flash_dq", torch.bfloat16,
                     *map(_ptr, (q, k, v, g, lse, delta, mask, dq)), b * h, h, tq, t_k, d=d,
                     scale=scale, causal=causal, tq=tq, tk=t_k)
        assert name == "flash_dq" + fa.TMA
        blind = dq[:, 0] if causal else dq[h:]
        assert float(blind.float().abs().max()) == 0.0
        seen = dq[:, 1:] if causal else dq[:h]
        want = fa.attention_dq_plain(q, k, v, g, lse, delta, mask, h, scale, causal)
        want = want[:, 1:] if causal else want[:h]
        err = (seen.float() - want.float()).abs().max() / want.float().abs().max()
        assert float(err) <= TOLS[torch.bfloat16][2]
    assert lib.emu_shared_overruns() == 0
