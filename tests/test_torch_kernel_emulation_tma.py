"""The TMA-fed K1-K3 in bf16 (`flash_fwd_tma`, `flash_dq_tma`,
`flash_dkv_tma`: `csrc/flash_attention_tma.cu`) run on the CPU, emulated
(`tests/cuda_emu`), against the plain versions, and the tensor-core
multiply-adds and wgmma instructions they issue.

The emulator runs each CUDA thread of a CTA as a host thread, so the
producer warp (TMA loads into the ring, the per-tile bias or lse and
delta, the "empty" waits) and the two consumer warpgroups (the "full"
waits, wgmma, the softmax or the gradient terms) run side by side; the
mbarriers keep their phases and transaction bytes, and TMA lands each box
in the 128-byte swizzle (D >= 64) or the 64-byte one (D = 32) with zeros
past the tensor's edges, as the PTX ISA lays them out. The cases, at D =
64, 128 and 256 (the widths all three kernels take), and at D = 32 for
K1 and K3 (K2 there runs its mma.sync 64-row tile): causal at T = 65 and
130 (diagonal and off-diagonal tiles, ragged ends), Tq != Tk key-padded,
and the row and key that see nothing (key 0 masked: its gradients
exactly 0); at D = 32 also a 64-row sequence in a 128-row tile.
Tolerances are the other emulation files' (`TOLS`, chip_smoke.py's),
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
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu"))
import emulate  # noqa: E402
from test_torch_kernel_emulation import TOLS, _arg, _call, check_kernels, lib  # noqa: E402,F401

# The head dims all three TMA-fed instances take, and those of K1 and K3.
ALL_THREE_DIMS = fa.TMA_HEAD_DIMS["flash_dq" + fa.TMA]
K1_K3_DIMS = fa.TMA_HEAD_DIMS["flash_fwd" + fa.TMA]
CASES = [(b, tq, tk, h, d, causal, mask)
         for d in ALL_THREE_DIMS
         for b, tq, tk, h, causal, mask in ((1, 65, 65, 1, True, "tail"),
                                             (1, 130, 130, 1, True, None),
                                             (2, 40, 96, 1, False, "tail"),
                                             (1, 72, 72, 2, True, "key0"))]
# D = 32 (64-byte rows): the same four, a 64-row sequence in a 128-row tile
# (causal, key-padded), and Tq > Tk with the key that no row sees.
D32_CASES = [(1, 65, 65, 1, 32, True, "tail"), (1, 130, 130, 1, 32, True, None),
             (2, 40, 96, 1, 32, False, "tail"), (1, 72, 72, 2, 32, True, "key0"),
             (2, 64, 64, 2, 32, True, "tail"), (1, 200, 72, 1, 32, False, "key0")]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", CASES + D32_CASES)
def test_tma_kernels_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    check_kernels(lib, torch.bfloat16, b, tq, tk, h, d, causal, mask_kind)


def test_the_cases_reach_the_tma_kernels_at_every_width():
    """Every case takes the TMA instances of its width (K2 at D = 32 its
    mma.sync 64-row tile); K1's and K2's T = 130 has a ragged second row
    tile and, at D = 128 and 256, several k-tiles per row tile on the
    diagonal; K3's T = 130 walks three q-tiles from its first key tile."""
    for b, tq, tk, h, d, causal, mask in CASES + D32_CASES:
        for kernel in fa.KERNELS:
            name = fa.instance(kernel, torch.bfloat16, d, tq, tk)
            tma = d in fa.TMA_HEAD_DIMS[kernel + fa.TMA]
            assert name == kernel + (fa.TMA if tma else "")
            assert fa.launch_config(tq, tk, d, name) == fa.KERNEL_TILES[kernel, d][1]
            assert fa.KERNEL_TILES[kernel, d][1] == (
                64 if not tma or (kernel == "flash_dkv" and d == 256) else 128)
    assert {c[4] for c in CASES} == set(ALL_THREE_DIMS)
    assert set(K1_K3_DIMS) == set(ALL_THREE_DIMS) | {32}
    for cases in (CASES, D32_CASES):
        assert {c[6] for c in cases} == {"tail", None, "key0"}
        assert any(c[1] != c[2] for c in cases) and any(c[1] % 64 for c in cases if c[5])
    assert any(max(c[1], c[2]) == 64 for c in D32_CASES)  # a sequence of half a tile


def _inputs(tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (torch.from_numpy(rng.randn(1, tq, d).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, tk, d).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, g


def _k1_pairs(tq, tk, d, causal):
    """K1's (group, key tile) pairs: 128 query rows a CTA, 64 a consumer
    group, kN keys a tile (128, or 64 at D = 32 and 256), each group up to
    the causal diagonal of its own rows."""
    rows, keys = 64, 64 if d in (32, 256) else 128
    pairs = 0
    for r0 in range(0, -(-tq // 128) * 128, rows):
        nk = -(-tk // keys)
        pairs += min(nk, (r0 + rows - 1) // keys + 1) if causal else nk
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


@pytest.mark.parametrize("d", ALL_THREE_DIMS)
@pytest.mark.parametrize("tq,tk,causal", [(130, 130, True), (40, 200, False)])
def test_each_product_is_formed_once_per_tile_pair(lib, d, tq, tk, causal):
    """The emulator's count of tensor-core multiply-adds of one launch: K1
    forms S and P.V once per (group's 64 rows, key tile) pair it visits (2
    x rows x keys x D), K2 S, dP and dQ (3 x rows x keys x D), K3 forms S^T,
    dP^T, dV and dK once per (key tile, q-tile) pair (4 x keys x 64 x D),
    at D = 256 too, where its two groups split the four products between
    them."""
    lib.emu_tensor_products.restype = ctypes.c_long
    q, k, v, g = _inputs(tq, tk, d, tq + d)
    scale = 1.0 / math.sqrt(d)
    shape = dict(tq=tq, tk=tk, d=d, scale=scale, causal=causal)
    out, lse = torch.empty_like(q), torch.empty(1, tq)
    name = _call(lib, "flash_fwd", torch.bfloat16, q, k, v, None, out, lse, 1, 1,
                 tq, tk, **shape)
    assert name == "flash_fwd" + fa.TMA
    rows, keys, pairs = _k1_pairs(tq, tk, d, causal)
    assert lib.emu_tensor_products() == pairs * 2 * rows * keys * d
    delta = (out.float() * g.float()).sum(-1)
    dq = torch.empty_like(q)
    name = _call(lib, "flash_dq", torch.bfloat16, q, k, v, g, lse, delta, None, dq,
                 1, 1, tq, tk, **shape)
    assert name == "flash_dq" + fa.TMA
    rows, keys, pairs = _k2_pairs(tq, tk, d, causal)
    assert lib.emu_tensor_products() == pairs * 3 * rows * keys * d
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    name = _call(lib, "flash_dkv", torch.bfloat16,
                 q, k, v, g, lse, delta, None, dk, dv, 1, 1, tq, tk, **shape)
    assert name == "flash_dkv" + fa.TMA
    keys, queries, pairs = _k3_pairs(tq, tk, d, causal)
    assert lib.emu_tensor_products() == pairs * 4 * keys * queries * d
    for t in (out, dq, dk):
        assert torch.isfinite(t.float()).all()
    assert lib.emu_shared_overruns() == 0


@pytest.mark.parametrize("d", ALL_THREE_DIMS)
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
                     q, k, v, g, lse, delta, mask, dq, b * h, h, tq, t_k, d=d,
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


@pytest.mark.parametrize("tq,tk,causal", [(130, 130, True), (40, 200, False), (64, 64, True)])
def test_d32_kernels_issue_k16_scores_and_n32_products(lib, tq, tk, causal):
    """K1 and K3 at D = 32, per tile pair, by the emulator's counts of
    wgmma instructions and multiply-adds: K1's two groups each form S with
    two SS m64n64k16 (K = 32: two k16 steps; 64 keys a tile, two CTAs an
    SM) and P.V with an RS m64n32k16 per 16 keys (4 a tile), a causal
    group only up to its own diagonal; K3's two groups each form S^T and dP^T
    with two SS m64n64k16 each and dV and dK with an RS m64n32k16 per 16
    queries (4 each a 64-query tile); no other form. K2 there is the
    mma.sync kernel: no wgmma."""
    lib.emu_tensor_products.restype = ctypes.c_long
    lib.emu_wgmma_instructions.restype = ctypes.c_long
    lib.emu_wgmma_instructions.argtypes = [ctypes.c_int, ctypes.c_int]
    d = 32
    forms = [(rs, n) for rs in (0, 1) for n in (8, 16, 32, 64, 128, 256)]

    def issued():
        return {(rs, n): lib.emu_wgmma_instructions(rs, n) for rs, n in forms
                if lib.emu_wgmma_instructions(rs, n)}

    q, k, v, g = _inputs(tq, tk, d, tq + tk)
    shape = dict(tq=tq, tk=tk, d=d, scale=1.0 / math.sqrt(d), causal=causal)
    out, lse = torch.empty_like(q), torch.empty(1, tq)
    assert _call(lib, "flash_fwd", torch.bfloat16, q, k, v, None, out, lse, 1, 1,
                 tq, tk, **shape) == "flash_fwd" + fa.TMA
    rows, keys, pairs = _k1_pairs(tq, tk, d, causal)
    assert (rows, keys) == (64, 64)
    assert lib.emu_tensor_products() == pairs * 2 * rows * keys * d
    assert issued() == {(0, 64): 2 * pairs, (1, 32): 4 * pairs}
    delta = (out.float() * g.float()).sum(-1)
    dq = torch.empty_like(q)
    assert _call(lib, "flash_dq", torch.bfloat16, q, k, v, g, lse, delta, None, dq,
                 1, 1, tq, tk, **shape) == "flash_dq"
    assert issued() == {}
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    assert _call(lib, "flash_dkv", torch.bfloat16, q, k, v, g, lse, delta, None, dk, dv,
                 1, 1, tq, tk, **shape) == "flash_dkv" + fa.TMA
    keys, queries, pairs = _k3_pairs(tq, tk, d, causal)
    assert (keys, queries) == (128, 64)
    assert lib.emu_tensor_products() == pairs * 4 * keys * queries * d
    assert issued() == {(0, 64): 8 * pairs, (1, 32): 16 * pairs}
    for t in (out, dq, dk, dv):
        assert torch.isfinite(t.float()).all()
    assert lib.emu_shared_overruns() == 0


def test_d32_long_tile_of_k1_and_k3_is_tma_fed_only(lib):
    """At D = 32 the entry points refuse the retired 64-row mma.sync tile of
    K1 and K3 (cudaErrorInvalidValue: no longer built), so nothing but the
    TMA-fed tile of 128 runs their long tile there; K2 still takes its
    64-row tile, and all three their short tile of 32."""
    d, t, scale = 32, 65, 1.0 / math.sqrt(32)
    q, k, v, g = _inputs(t, t, d, 5)
    out, lse, dq, dk, dv = (torch.zeros_like(q), torch.zeros(1, t), torch.zeros_like(q),
                            torch.zeros_like(k), torch.zeros_like(v))
    delta = torch.zeros(1, t)
    calls = {"swt_flash_fwd": (q, k, v, None, out, lse),
             "swt_flash_dq": (q, k, v, g, lse, delta, None, dq),
             "swt_flash_dkv": (q, k, v, g, lse, delta, None, dk, dv)}

    def rc(entry, tile):
        return getattr(lib, entry)(*(_arg(x, 1) for x in calls[entry]), 1, 1, t, t, d, tile,
                                   scale, 1, 0, None)

    assert rc("swt_flash_fwd", 64) == 1 and rc("swt_flash_dkv", 64) == 1
    assert rc("swt_flash_dq", 128) == 1  # no TMA-fed K2 at D = 32
    assert [rc(entry, 128) for entry in ("swt_flash_fwd", "swt_flash_dkv")] == [0, 0]
    assert rc("swt_flash_dq", 64) == 0
    assert [rc(entry, 32) for entry in calls] == [0, 0, 0]


@pytest.fixture(scope="module")
def swizzle_probe(tmp_path_factory):
    if emulate.compiler() is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = str(tmp_path_factory.mktemp("swizzle_probe"))
    path = emulate.build(out, sources=(os.path.join(emulate.HERE, "swizzle_probe.cu"),),
                         name="libswizzle_probe.so")
    probe = ctypes.CDLL(path)
    probe.swt_swizzle_probe.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    probe.swt_swizzle_probe.restype = ctypes.c_int
    return probe


@pytest.mark.parametrize("rows", [64, 128])
def test_a_64_byte_swizzled_box_reads_back_through_both_descriptors(swizzle_probe, rows):
    """A box of 32 bf16 columns lands through the kernels' own tensor_map
    and tma_load at a 512-byte boundary in the 64-byte swizzle (the map
    says CU_TENSOR_MAP_SWIZZLE_64B = 2): byte offset o = 64 r + 2 c of
    element (r, c) moves to o ^ (((o >> 7) & 3) << 4), the PTX ISA's
    pattern, reckoned here apart from the emulator. Read back through a
    K-major descriptor (layout type 2, 512-byte 8-row stride, k16 steps
    32 bytes on) and an MN-major one (k16 steps 16 rows, 1 KB, on), every
    element is the one that went in."""
    rng = np.random.RandomState(rows)
    x = torch.from_numpy(rng.randn(rows, 32).astype(np.float32)).to(torch.bfloat16)
    landed = torch.zeros(rows, 32, dtype=torch.bfloat16)
    k_major, mn_major = (torch.full((rows, 32), math.nan) for _ in range(2))
    swizzle = ctypes.c_int(-1)
    assert swizzle_probe.swt_swizzle_probe(x.data_ptr(), rows, landed.data_ptr(),
                                           k_major.data_ptr(), mn_major.data_ptr(),
                                           ctypes.addressof(swizzle)) == 0
    assert swizzle.value == 2
    flat = landed.flatten()
    for r in range(rows):
        for c in range(32):
            o = 64 * r + 2 * c
            assert torch.equal(flat[(o ^ (((o >> 7) & 3) << 4)) // 2], x[r, c]), (r, c)
    assert not torch.equal(landed, x)  # the rows did move
    assert torch.equal(k_major, x.float()) and torch.equal(mn_major, x.float())
