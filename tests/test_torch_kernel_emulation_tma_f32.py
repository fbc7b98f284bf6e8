"""The TMA-fed K1-K3 in f32 (`flash_fwd_f32_tma`, `flash_dq_f32_tma`,
`flash_dkv_f32_tma`: `csrc/flash_attention_tma_f32.cu`) run on the CPU,
emulated (`tests/cuda_emu`), against the plain versions, and the
tensor-core multiply-adds each launch runs.

The emulator runs each CUDA thread of a CTA as a host thread, so the
producer thread (TMA loads into the ring), the helper warps (each tile's
small TF32 planes and its key bias, or K3's lse and delta) and the two
consumer warpgroups (the "full" waits, TF32 wgmma from registers and from
the staged planes, the softmax or the gradient terms, the groups' merge,
K3's hand-off of P^T through its planes) run side by side; the mbarriers
keep their phases and transaction bytes, and TMA lands each f32 box of 32
columns in the 128-byte swizzle with zeros past the tensor's edges, as
the PTX ISA lays them out. The cases, at each instance's head dims (K1 at
D = 64, 128 and 256; K2 and K3 at 32 too, where the helpers also stage
the transposed planes of K, Q and dO and the output products take their
A from the score accumulators): causal at T = 65 and 130 (diagonal and
off-diagonal tiles, ragged ends, both consumer groups' k-tiles, K3's
q-tiles from the diagonal on), Tq != Tk key-padded (40 against 200), and
the row and key that see nothing (key 0 masked: its gradients exactly
0); at D = 32 the f32 K1 of those cases is the `mma.sync` long tile. Tolerances are the other emulation files' f32 ones
(`TOLS`, chip_smoke.py's 1e-4), through
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
from test_torch_kernel_emulation import TOLS, _call, check_kernels, lib  # noqa: E402,F401

F32_TMA = ("flash_fwd_f32" + fa.TMA, "flash_dq_f32" + fa.TMA, "flash_dkv_f32" + fa.TMA)
# The head dims each of the three is built for (its TMA_HEAD_DIMS), and
# all of them.
HEAD_DIMS = {name: fa.TMA_HEAD_DIMS[name] for name in F32_TMA}
F32_TMA_HEAD_DIMS = tuple(sorted(set().union(*HEAD_DIMS.values())))
CASES = [(b, tq, tk, h, d, causal, mask)
         for d in F32_TMA_HEAD_DIMS
         for b, tq, tk, h, causal, mask in ((1, 65, 65, 1, True, "tail"),
                                             (1, 130, 130, 1, True, None),
                                             (2, 40, 200, 1, False, "tail"),
                                             (1, 72, 72, 2, True, "key0"))]
# Keys a k-tile by head dim: K1's (K, K's small plane and V a stage) and
# K2's (and V's small plane; at D = 32 K's transposed planes too), as
# csrc/flash_attention_tma_f32.cu sizes them; K3's queries a q-tile (Q, dO
# and their small planes a stage; at D = 32 their transposed planes too).
K1_KEYS = {64: 64, 128: 32, 256: 16}
K2_KEYS = {32: 64, 64: 64, 128: 32, 256: 8}
K3_QUERIES = {32: 64, 64: 32, 128: 32, 256: 16}
GROUP_ROWS = 64  # a consumer group's rows: a wgmma's M


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", CASES)
def test_tma_f32_kernels_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    check_kernels(lib, torch.float32, b, tq, tk, h, d, causal, mask_kind)


def _rows(name, d):
    """Query rows (K1, K2) or keys (K3) a CTA of TMA instance `name` owns
    at head dim d: its long tile."""
    return fa.KERNEL_TILES[name, d][1]


def test_the_cases_reach_the_tma_f32_kernels_at_every_width():
    """Every case takes the f32 TMA-fed instances at their head dims, at
    their long tile (K1's and K2's query rows, K3's keys: 64, and 128 for
    K2 and K3 at D = 32), and at D = 32 the f32 K1's `mma.sync` long tile;
    T = 130 has a ragged third row tile and several k-tiles per group on
    the diagonal at every D, K3's key tiles several q-tiles each, T = 65
    one row past the short tile."""
    for b, tq, tk, h, d, causal, mask in CASES:
        for kernel, tma in zip(fa.KERNELS, F32_TMA):
            name = fa.instance(kernel, torch.float32, d, tq, tk)
            if d in HEAD_DIMS[tma]:
                assert name == tma
                assert fa.launch_config(tq, tk, d, name) == _rows(name, d)
                assert _rows(name, d) == (128 if d == 32 else GROUP_ROWS)
            else:
                assert (name, d) == ("flash_fwd_f32", 32)
                assert fa.launch_config(tq, tk, d, name) == fa.KERNEL_TILES[name, d][1] == 64
    assert set(F32_TMA) <= set(fa.TMA_INSTANCES)
    assert HEAD_DIMS == {F32_TMA[0]: (64, 128, 256), F32_TMA[1]: (32, 64, 128, 256),
                         F32_TMA[2]: (32, 64, 128, 256)}
    assert {c[4] for c in CASES} == set(F32_TMA_HEAD_DIMS)
    assert {c[6] for c in CASES} == {"tail", None, "key0"}
    assert any(c[1] != c[2] for c in CASES) and any(c[1] % 64 for c in CASES if c[5])
    assert any(max(c[1], c[2]) == fa.KERNEL_TILES["flash_fwd_f32", 64][2] + 1 for c in CASES)


def _inputs(tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (torch.from_numpy(rng.randn(1, tq, d).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, tk, d).astype(np.float32)) for _ in range(2))
    return q, k, v, g


def _pairs(tq, tk, keys, causal, rows):
    """(group rows, key tile) pairs a launch forms: CTAs of `rows` query
    rows, 64 a consumer group (a group of a 64-row CTA takes every other
    tile of the CTA's), `keys` keys a k-tile, up to the CTA's causal
    diagonal, a group of a 128-row CTA to its own."""
    pairs, nk = 0, -(-tk // keys)
    for q0 in range(0, tq, rows):
        nk_cta = min(nk, (q0 + rows - 1) // keys + 1) if causal else nk
        for r0 in range(q0, q0 + rows, GROUP_ROWS):
            pairs += min(nk_cta, (r0 + GROUP_ROWS - 1) // keys + 1) if causal else nk_cta
    return pairs


def _k3_pairs(tq, tk, queries, causal, keys):
    """K3's (group keys, q-tile) pairs: CTAs of `keys` keys, 64 a consumer
    group, `queries` queries a q-tile, from the causal diagonal on (a
    group of a 128-key CTA from its own)."""
    return sum(max(-(-tq // queries) - (k0 // queries if causal else 0), 0)
               for k0 in range(0, -(-tk // keys) * keys, GROUP_ROWS))


@pytest.mark.parametrize("d", F32_TMA_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk,causal", [(130, 130, True), (40, 200, False)])
def test_each_product_is_formed_once_per_tile_pair(lib, d, tq, tk, causal):
    """The emulator's count of tensor-core multiply-adds of one launch, as
    3xTF32 (three TF32 products each), over the (64 rows of a consumer
    group, streamed tile) pairs: K1 forms S and P.V once per (row tile,
    key tile) pair it visits (3 x 2 x 64 x keys x D), K2 S, dP and dQ (3 x
    3 x 64 x keys x D); the two consumer groups take the pairs in turns
    (at D = 32 each its own 64 rows), and neither forms a pair twice. K3
    forms S^T, dP^T, dV and dK once per (key group, q-tile) pair (3 x 4 x
    64 x queries x D), at D = 64-256 its two groups two products each, at
    D = 32 each group all four for its own 64 keys. K1 at D = 32 is the
    `mma.sync` kernel, not counted here."""
    lib.emu_tensor_products.restype = ctypes.c_long
    q, k, v, g = _inputs(tq, tk, d, tq + d)
    scale = 1.0 / math.sqrt(d)
    shape = dict(tq=tq, tk=tk, d=d, scale=scale, causal=causal)
    out, lse = torch.empty_like(q), torch.empty(1, tq)
    name = _call(lib, "flash_fwd", torch.float32, q, k, v, None, out, lse, 1, 1,
                 tq, tk, **shape)
    if d in HEAD_DIMS[F32_TMA[0]]:
        assert name == F32_TMA[0]
        keys = K1_KEYS[d]
        assert (lib.emu_tensor_products()
                == _pairs(tq, tk, keys, causal, _rows(name, d)) * 3 * 2 * GROUP_ROWS * keys * d)
    delta = (out * g).sum(-1)
    dq = torch.empty_like(q)
    name = _call(lib, "flash_dq", torch.float32, q, k, v, g, lse, delta, None, dq,
                 1, 1, tq, tk, **shape)
    assert name == F32_TMA[1]
    keys = K2_KEYS[d]
    assert (lib.emu_tensor_products()
            == _pairs(tq, tk, keys, causal, _rows(name, d)) * 3 * 3 * GROUP_ROWS * keys * d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    name = _call(lib, "flash_dkv", torch.float32,
                 q, k, v, g, lse, delta, None, dk, dv, 1, 1, tq, tk, **shape)
    assert name == F32_TMA[2]
    queries = K3_QUERIES[d]
    assert (lib.emu_tensor_products()
            == _k3_pairs(tq, tk, queries, causal, _rows(name, d))
            * 3 * 4 * GROUP_ROWS * queries * d)
    for t in (out, lse, dq, dk, dv):
        assert torch.isfinite(t).all()
    assert lib.emu_shared_overruns() == 0


@pytest.mark.parametrize("d", HEAD_DIMS[F32_TMA[1]])
def test_a_row_that_sees_no_key_gets_zero_dq(lib, d):
    """dQ of every query row that sees no key is exactly 0 from the f32
    TMA-fed K2: the causal row 0 with key 0 masked, and every row of a batch
    whose keys are all masked (Tq != Tk, several k-tiles for each consumer
    group at every D); the other batch's dQ stays within the f32 tolerance
    of the plain version."""
    b, tq, tk, h = 2, 65, 130, 2
    scale = 1.0 / math.sqrt(d)
    for causal, t_k in ((True, tq), (False, tk)):
        rng = np.random.RandomState(d + t_k)
        q, g = (torch.from_numpy(rng.randn(b * h, tq, d).astype(np.float32)) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(b * h, t_k, d).astype(np.float32)) for _ in range(2))
        mask = torch.ones(b, t_k, dtype=torch.bool)
        if causal:
            mask[:, 0] = False
        else:
            mask[1] = False
        out, lse = fa.attention_forward_plain(q, k, v, mask, h, scale, causal)
        delta = (out * g).sum(-1)
        dq = torch.full_like(q, math.nan)
        name = _call(lib, "flash_dq", torch.float32,
                     q, k, v, g, lse, delta, mask, dq, b * h, h, tq, t_k, d=d,
                     scale=scale, causal=causal, tq=tq, tk=t_k)
        assert name == F32_TMA[1]
        blind = dq[:, 0] if causal else dq[h:]
        assert float(blind.abs().max()) == 0.0
        seen = dq[:, 1:] if causal else dq[:h]
        want = fa.attention_dq_plain(q, k, v, g, lse, delta, mask, h, scale, causal)
        want = want[:, 1:] if causal else want[:h]
        err = (seen - want).abs().max() / want.abs().max()
        assert float(err) <= TOLS[torch.float32][2]
    assert lib.emu_shared_overruns() == 0


@pytest.mark.parametrize("d", HEAD_DIMS[F32_TMA[2]])
def test_a_key_that_no_row_sees_gets_zero_dk_and_dv(lib, d):
    """dK and dV of every key that no query sees are exactly 0 from the
    f32 TMA-fed K3: the masked key 0 (causal, several q-tiles from the
    diagonal on), and every key of a batch whose keys are all masked (Tq
    != Tk, two key tiles); the other keys' dK and dV stay within the f32
    tolerance of the plain version."""
    b, tq, tk, h = 2, 65, 130, 2
    scale = 1.0 / math.sqrt(d)
    for causal, t_q, t_k in ((True, tq, tq), (False, tq, tk)):
        rng = np.random.RandomState(d + t_k)
        q, g = (torch.from_numpy(rng.randn(b * h, t_q, d).astype(np.float32)) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(b * h, t_k, d).astype(np.float32)) for _ in range(2))
        mask = torch.ones(b, t_k, dtype=torch.bool)
        if causal:
            mask[:, 0] = False
        else:
            mask[1] = False
        out, lse = fa.attention_forward_plain(q, k, v, mask, h, scale, causal)
        delta = (out * g).sum(-1)
        dk, dv = torch.full_like(k, math.nan), torch.full_like(v, math.nan)
        name = _call(lib, "flash_dkv", torch.float32,
                     q, k, v, g, lse, delta, mask, dk, dv, b * h, h, t_q, t_k, d=d,
                     scale=scale, causal=causal, tq=t_q, tk=t_k)
        assert name == F32_TMA[2]
        want = fa.attention_dkv_plain(q, k, v, g, lse, delta, mask, h, scale, causal)
        for got, ref in zip((dk, dv), want):
            blind = got[:, 0] if causal else got[h:]
            assert float(blind.abs().max()) == 0.0
            seen, ref = (got[:, 1:], ref[:, 1:]) if causal else (got[:h], ref[:h])
            err = (seen - ref).abs().max() / ref.abs().max()
            assert float(err) <= TOLS[torch.float32][2]
    assert lib.emu_shared_overruns() == 0
