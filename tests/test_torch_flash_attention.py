"""The port's flash attention against the JAX package's, on the CPU in f32
(and in bf16 at the head dims it pads).

The same numpy inputs go through `shockwave_tpu.ops.flash_attention`
(Pallas in interpret mode, as tests/test_ops.py runs it) and through
`shockwave_tpu_torch.ops.flash_attention`, whose wrappers take their
plain PyTorch versions for CPU tensors. Tolerances are test_ops.py's:
2e-5 on the forward, 5e-4 on gradients. The CUDA kernels' tile choice,
`launch_config`, is plain Python and is held here too.
"""
import ctypes
import importlib
import math
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu.ops import flash_attention as jax_flash_attention
from shockwave_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("shockwave_tpu.ops.flash_attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests share the machine with the rest of the suite's workers
    (some of them timing-sensitive loopbacks); their tensors are tiny, so
    one intra-op thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

FWD_TOL = 2e-5
GRAD_TOL = 5e-4


def rand_qkv(rng, b, t, h, d, tk=None):
    tk = tk or t
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, tk, h, d).astype(np.float32),
            rng.randn(b, tk, h, d).astype(np.float32))


# Each helper takes f32 numpy inputs, runs them in `dtype` ("float32" or
# "bfloat16") and returns f32 numpy arrays.

def torch_out(q, k, v, dtype="float32", **kw):
    kpm = kw.pop("key_padding_mask", None)
    if kpm is not None:
        kpm = torch.from_numpy(kpm)
    out = fa.flash_attention(*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
                             key_padding_mask=kpm, **kw)
    return out.float().numpy()


def jax_out(q, k, v, dtype="float32", **kw):
    kpm = kw.pop("key_padding_mask", None)
    if kpm is not None:
        kpm = jnp.asarray(kpm)
    return np.asarray(jax_flash_attention(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)), key_padding_mask=kpm, **kw),
        np.float32)


def torch_grads(q, k, v, kpm, causal, dtype="float32"):
    qt, kt, vt = (torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
                  for x in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=causal,
                             key_padding_mask=torch.from_numpy(kpm))
    (out.float() ** 2).sum().backward()
    return [t.grad.float().numpy() for t in (qt, kt, vt)]


def jax_grads(q, k, v, kpm, causal, dtype="float32", **blocks):
    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal,
                                  key_padding_mask=jnp.asarray(kpm), **blocks)
        return (out.astype(jnp.float32) ** 2).sum()
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in grads]


class TestFlashAttention:
    @pytest.mark.parametrize("t,causal", [(128, False), (128, True),
                                          (32, True)])
    def test_forward_parity(self, t, causal):
        rng = np.random.RandomState(0)
        q, k, v = rand_qkv(rng, 2, t, 2, 64)
        err = np.abs(torch_out(q, k, v, causal=causal)
                     - jax_out(q, k, v, causal=causal)).max()
        assert err < FWD_TOL, err

    def test_key_padding_mask(self):
        rng = np.random.RandomState(1)
        q, k, v = rand_qkv(rng, 2, 128, 2, 64)
        kpm = rng.rand(2, 128) > 0.3
        err = np.abs(torch_out(q, k, v, key_padding_mask=kpm)
                     - jax_out(q, k, v, key_padding_mask=kpm)).max()
        assert err < FWD_TOL, err

    def test_cross_attention_lengths(self):
        rng = np.random.RandomState(2)
        q, k, v = rand_qkv(rng, 1, 64, 2, 64, tk=128)
        assert torch_out(q, k, v).shape == (1, 64, 2, 64)
        err = np.abs(torch_out(q, k, v) - jax_out(q, k, v)).max()
        assert err < FWD_TOL, err

    def test_gradients_match(self):
        rng = np.random.RandomState(3)
        q, k, v = rand_qkv(rng, 1, 64, 2, 64)
        kpm = rng.rand(1, 64) > 0.2
        for a, b in zip(torch_grads(q, k, v, kpm, True),
                        jax_grads(q, k, v, kpm, True)):
            assert np.abs(a - b).max() < GRAD_TOL

    def test_fully_masked_row_leaks_no_gradient(self):
        """causal + key 0 padded: query row 0 sees no key. Its gradient
        contribution is exactly zero in both packages (the p = 0 where
        s <= NEG_INF/2 guard), and every gradient matches the JAX
        package's multi-block run."""
        rng = np.random.RandomState(5)
        t = 128
        q, k, v = rand_qkv(rng, 1, t, 2, 64)
        kpm = np.ones((1, t), bool)
        kpm[0, 0] = False
        g_port = torch_grads(q, k, v, kpm, True)
        g_jax = jax_grads(q, k, v, kpm, True, block_q=32, block_k=32)
        assert np.abs(g_port[0][0, 0]).max() == 0.0
        assert np.abs(g_port[1][0, 0]).max() == 0.0
        assert np.abs(g_port[2][0, 0]).max() == 0.0
        for a, b in zip(g_port, g_jax):
            assert np.abs(a - b).max() < GRAD_TOL
        # Rows that see a key agree; row 0's output depends on tiling.
        out_p = torch_out(q, k, v, causal=True, key_padding_mask=kpm)
        out_j = jax_out(q, k, v, causal=True, key_padding_mask=kpm,
                        block_q=32, block_k=32)
        assert np.abs(out_p[:, 1:] - out_j[:, 1:]).max() < FWD_TOL

    def test_fused_qkv_views_match(self):
        """q, k and v as slices of one (B, T, 3, H, D) projection (rows 3 H
        D apart, as the kernels take them in place on the card): forward
        and gradients against the JAX package on the same numbers."""
        rng = np.random.RandomState(9)
        qkv = rng.randn(2, 64, 3, 2, 64).astype(np.float32)
        kpm = rng.rand(2, 64) > 0.2
        fused = torch.from_numpy(qkv).requires_grad_()
        q, k, v = fused.unbind(2)
        assert q.stride(1) == 3 * 2 * 64
        out = fa.flash_attention(q, k, v, causal=True, key_padding_mask=torch.from_numpy(kpm))
        want = jax_out(*(qkv[:, :, i] for i in range(3)), causal=True, key_padding_mask=kpm)
        assert np.abs(out.detach().numpy() - want).max() < FWD_TOL
        (out.float() ** 2).sum().backward()
        for i, g in enumerate(jax_grads(*(qkv[:, :, i] for i in range(3)), kpm, True)):
            assert np.abs(fused.grad[:, :, i].numpy() - g).max() < GRAD_TOL

    def test_causal_cross_rejected(self):
        rng = np.random.RandomState(4)
        q, k, v = rand_qkv(rng, 1, 64, 2, 64, tk=128)
        with pytest.raises(ValueError):
            torch_out(q, k, v, causal=True)


def bhtd(rng, bh, t, d):
    return rng.randn(bh, t, d).astype(np.float32)


# (heads, B, Tq, Tk, causal, block): multi-block JAX grids, masks with no
# fully masked row.
KERNEL_CASES = [(2, 2, 64, 64, True, 32), (2, 1, 64, 128, False, 32),
                (1, 2, 32, 32, False, 32)]


class TestPlainVersionsAgainstPallasKernels:
    """Each plain version against the Pallas kernel it stands beside, on
    identical inputs (the JAX side in interpret mode)."""

    @staticmethod
    def _inputs(seed, heads, b, tq, tk):
        rng = np.random.RandomState(seed)
        q, g = bhtd(rng, b * heads, tq, 64), bhtd(rng, b * heads, tq, 64)
        k, v = bhtd(rng, b * heads, tk, 64), bhtd(rng, b * heads, tk, 64)
        mask = np.ones((b, tk), bool)
        mask[:, 1::3] = rng.rand(b, len(range(1, tk, 3))) > 0.5  # key 0 stays
        return q, k, v, g, mask

    @pytest.mark.parametrize("heads,b,tq,tk,causal,block", KERNEL_CASES)
    def test_forward_and_lse(self, heads, b, tq, tk, causal, block):
        q, k, v, _, mask = self._inputs(0, heads, b, tq, tk)
        scale = 1.0 / 8.0
        out_j, lse_j = jfa._forward_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(np.repeat(mask, heads, axis=0).astype(np.int8)),
            scale, causal, block, block, True)
        out_p, lse_p = fa.attention_forward_plain(
            *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
            heads, scale, causal)
        assert np.abs(out_p.numpy() - np.asarray(out_j)).max() < FWD_TOL
        assert np.abs(lse_p.numpy() - np.asarray(lse_j)[..., 0]).max() < FWD_TOL

    @pytest.mark.parametrize("heads,b,tq,tk,causal,block", KERNEL_CASES)
    def test_dq_and_dkv(self, heads, b, tq, tk, causal, block):
        q, k, v, g, mask = self._inputs(1, heads, b, tq, tk)
        scale = 1.0 / 8.0
        jmask = jnp.asarray(np.repeat(mask, heads, axis=0).astype(np.int8))
        jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
        out_j, lse_j = jfa._forward_impl(jq, jk, jv, jmask, scale, causal,
                                         block, block, True)
        dq_j, dk_j, dv_j = jfa._backward_impl(jq, jk, jv, jmask, out_j, lse_j,
                                              jg, scale, causal, block, block,
                                              True)
        out = torch.from_numpy(np.array(out_j))
        tg = torch.from_numpy(g)
        delta = (out * tg).sum(-1)
        lse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy())
        args = (*(torch.from_numpy(x) for x in (q, k, v)), tg, lse, delta,
                torch.from_numpy(mask), heads, scale, causal)
        dq = fa.attention_dq_plain(*args)
        dk, dv = fa.attention_dkv_plain(*args)
        for a, b_ in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
            assert np.abs(a.numpy() - np.asarray(b_)).max() < GRAD_TOL


class TestWrappers:
    def test_cpu_tensors_take_the_plain_versions(self):
        fa.reset_launch_counts()
        rng = np.random.RandomState(7)
        q, k, v = (torch.from_numpy(x).requires_grad_()
                   for x in rand_qkv(rng, 1, 32, 2, 32))
        fa.flash_attention(q, k, v, causal=True).sum().backward()
        assert set(fa.LAUNCHES) == {"flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_f32",
                                    "flash_dq_f32", "flash_dkv_f32", "flash_fwd_wide",
                                    "flash_dq_wide", "flash_dkv_wide", "flash_fwd_wide_f32",
                                    "flash_dq_wide_f32", "flash_dkv_wide_f32", "flash_fwd_tma",
                                    "flash_dq_tma", "flash_dkv_tma", "flash_fwd_f32_tma",
                                    "flash_dq_f32_tma", "flash_dkv_f32_tma",
                                    "flash_bwd_delta", "flash_bwd_delta_f32"}
        assert not any(fa.LAUNCHES.values())

    def test_other_devices_raise(self):
        q = torch.empty(2, 32, 64, device="meta")
        with pytest.raises(ValueError):
            fa.attention_forward(q, q, q, None, 1, 0.125, False)
        with pytest.raises(ValueError):
            fa.attention_forward(q, torch.zeros(2, 32, 64), q, None, 1, 0.125,
                                 False)

    def test_default_scale_and_output_dtype(self):
        rng = np.random.RandomState(8)
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in rand_qkv(rng, 1, 16, 2, 32))
        out = fa.flash_attention(q, k, v)
        ref = fa.flash_attention(q, k, v, scale=1.0 / np.sqrt(32))
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, ref)


class TestRaggedEdgesAgainstJax:
    """The lengths on either side of the CUDA kernels' short tile
    (chip_smoke.py's edge cases: T = 17, T = 33, Tq 32 against Tk 48),
    with padded key tails, against the JAX package, whose blocks shrink
    to the sequence length. On the CPU this covers the plain versions at
    these ragged lengths; the kernels' tiles are held at the same lengths
    on the card by chip_smoke.py."""

    @pytest.mark.parametrize("tq,tk,causal", [(17, 17, True), (33, 33, True),
                                              (32, 48, False), (33, 33, False)])
    def test_forward(self, tq, tk, causal):
        rng = np.random.RandomState(tq + tk)
        q, k, v = rand_qkv(rng, 3, tq, 2, 64, tk=tk)
        kpm = np.arange(tk)[None, :] < rng.randint(tk // 2 + 1, tk + 1, (3, 1))
        err = np.abs(torch_out(q, k, v, causal=causal, key_padding_mask=kpm)
                     - jax_out(q, k, v, causal=causal, key_padding_mask=kpm)).max()
        assert err < FWD_TOL, err

    @pytest.mark.parametrize("t", [17, 33])
    def test_gradients(self, t):
        rng = np.random.RandomState(t)
        q, k, v = rand_qkv(rng, 2, t, 2, 32)
        kpm = np.arange(t)[None, :] < np.array([[t], [t // 2 + 1]])
        for a, b in zip(torch_grads(q, k, v, kpm, True),
                        jax_grads(q, k, v, kpm, True)):
            assert np.abs(a - b).max() < GRAD_TOL


class TestHeadDim32AgainstJax:
    """Head dims 32 and 16 (padded to 32) at sequences past the short tile,
    where on the card K1 and K3 run their TMA-fed instances on 64-byte
    rows and K2 its mma.sync tile: the port (its plain versions on the
    CPU) against the JAX package, forward and gradients, causal and
    key-padded, in f32."""

    @pytest.mark.parametrize("d", [16, 32])
    @pytest.mark.parametrize("t,causal", [(64, True), (128, True), (128, False)])
    def test_forward_and_gradients(self, d, t, causal):
        rng = np.random.RandomState(t + d)
        q, k, v = rand_qkv(rng, 2, t, 2, d)
        kpm = np.arange(t)[None, :] < np.array([[t], [t // 2 + 3]])
        err = np.abs(torch_out(q, k, v, causal=causal, key_padding_mask=kpm)
                     - jax_out(q, k, v, causal=causal, key_padding_mask=kpm)).max()
        assert err < FWD_TOL, err
        for a, b in zip(torch_grads(q, k, v, kpm, causal), jax_grads(q, k, v, kpm, causal)):
            assert np.abs(a - b).max() < GRAD_TOL


def _chip_smoke():
    """chip_smoke.py as a module (it imports only torch at the top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class TestLaunchConfig:
    """`launch_config` picks each kernel instance's square tile on the
    host, so its choice is testable here; the kernels themselves run on
    the card."""

    LENGTHS = list(range(1, 70)) + [96, 127, 128, 129, 512, 2048, 4097]
    # The 3xTF32 instances, whose short tile is one warp of 16 rows.
    TF32_INSTANCES = ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32")

    @pytest.mark.parametrize("d", fa.KERNEL_HEAD_DIMS)
    def test_total_over_accepted_shapes(self, d):
        for name in fa.INSTANCES:
            short, long, short_up_to = fa.KERNEL_TILES[name, d]
            for tq in self.LENGTHS:
                for tk in self.LENGTHS:
                    tile = fa.launch_config(tq, tk, d, name)
                    assert tile in (short, long)
                    # The short tile only where both sequences are in its reach.
                    assert (tile == short) == (max(tq, tk) <= short_up_to)
                    if name not in self.TF32_INSTANCES:  # bf16: 32, then 64 (K2
                        # at D = 32, mma.sync) or the TMA-fed K1's and K2's
                        # 128 rows and K3's 128 keys (64 at D = 256)
                        long = (64 if d == 32 and name == "flash_dq" else
                                128 if name != "flash_dkv" or d < 256 else 64)
                        assert tile == (32 if max(tq, tk) <= 32 else long)
                        assert (fa.instance(name, torch.bfloat16, d, tq, tk)
                                == fa.tile_instance(name, d, tile))
                    else:  # f32: 16, then 64, at D = 64-256 the TMA-fed
                        # instances' 64 rows (K1's and K2's queries, K3's keys)
                        assert tile == (16 if max(tq, tk) <= 64 else 64)
                        assert (fa.instance(name.removesuffix("_f32"), torch.float32, d, tq, tk)
                                == fa.tile_instance(name, d, tile))
                    if name == "flash_fwd":  # the default instance
                        assert fa.launch_config(tq, tk, d) == tile

    def test_tf32_instances_fill_the_card_at_the_decoders_shape(self):
        """The f32 decoder's flash path, (8, 64, 4 x 32) causal: K1, K2 and
        K3 in f32 take one-warp CTAs of 16 rows, (32, 4) = 128 CTAs for
        the card's 132 SMs rather than (32, 1); the bf16 instances keep
        their 64-row tile there."""
        bh, t, d = 8 * 4, 64, 32
        assert set(self.TF32_INSTANCES) == {n for n in fa.INSTANCES if n.endswith("_f32")}
        for name in self.TF32_INSTANCES:
            tile = fa.launch_config(t, t, d, name)
            assert tile == 16 and bh * -(-t // tile) == 128
            assert fa.KERNEL_TILES[name, d] == (16, 64, 64)
        assert fa.launch_config(t, t, d, "flash_dq") == 64

    def test_rejects_what_the_wrapper_rejects(self):
        """Widths the wrapper never hands over: not a template instance's
        (16 ... 600 for K1's instance), not a multiple of 256 above 256
        (the wide instance's: 256 is a template width)."""
        for d in (16, 48, 96, 129, 257, 512, 600):
            with pytest.raises(ValueError):
                fa.launch_config(32, 32, d)
        for name in fa.WIDE_INSTANCES:
            for d in (64, 256, 257, 320, 600):
                with pytest.raises(ValueError):
                    fa.launch_config(32, 32, d, name)
            short, long, short_up_to = fa.WIDE_TILES[name]
            for t in self.LENGTHS:
                assert {fa.launch_config(t, t, d, name) for d in (512, 768, 1024)} == {
                    short if t <= short_up_to else long}
            assert {fa.launch_config(t, t, 512, name) for t in self.LENGTHS} == {short, long}
        for tq, tk in ((0, 32), (32, 0)):
            with pytest.raises(ValueError):
                fa.launch_config(tq, tk, 64)
        empty = torch.zeros(2, 0, 64, dtype=torch.bfloat16)
        full = torch.zeros(2, 32, 64, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            fa._check_kernel_inputs(empty, full, full, None, 1)

    def test_main_shape_gets_the_short_tile(self):
        # The trainer's self- and cross-attention: src 32, tgt[:, :-1] 32.
        assert fa.launch_config(32, 32, 64) == 32
        smoke = _chip_smoke()
        main = [c for c in smoke.CASES if c[0].startswith("main_")]
        assert len(main) == 3
        for _, _, tq, tk, _, d, _, _ in main:
            assert fa.launch_config(tq, tk, d) == 32

    @pytest.mark.parametrize("t", [33, 48, 64, 100, 128, 2048])
    def test_head_dim_32_past_the_short_tile_takes_tma_k1_and_k3(self, t):
        """In bf16 at head dim 32 (and d = 16, which pads to it), past T =
        32: `instance`, `launch_config` and `tile_instance` pick the
        TMA-fed K1 and K3 (128 rows, 128 keys) and K2's mma.sync 64-row
        tile; the longer sequence decides; up to T = 32 all three keep
        the short tile, and f32 keeps its mma.sync instances."""
        assert fa.kernel_head_dim(16) == fa.kernel_head_dim(32) == 32
        for kernel, want, tile in (("flash_fwd", "flash_fwd_tma", 128),
                                   ("flash_dq", "flash_dq", 64),
                                   ("flash_dkv", "flash_dkv_tma", 128)):
            for tq, tk in ((t, t), (16, t), (t, 16)):
                got = fa.instance(kernel, torch.bfloat16, 32, tq, tk)
                assert got == want
                assert fa.launch_config(tq, tk, 32, got) == tile
            assert fa.tile_instance(kernel, 32, tile) == want
            assert fa.tile_instance(kernel, 32, 32) == kernel
            assert fa.instance(kernel, torch.bfloat16, 32, 32, 32) == kernel
            assert fa.launch_config(32, 32, 32, kernel) == 32
            assert fa.instance(kernel, torch.float32, 32, t, t) == kernel + "_f32"
        assert fa.TMA_HEAD_DIMS["flash_fwd" + fa.TMA] == fa.TMA_HEAD_DIMS["flash_dkv" + fa.TMA]
        assert 32 in fa.TMA_HEAD_DIMS["flash_fwd" + fa.TMA]
        assert 32 not in fa.TMA_HEAD_DIMS["flash_dq" + fa.TMA]
        assert all(32 not in fa.TMA_HEAD_DIMS[n] for n in fa.TMA_INSTANCES if "_f32" in n)

    def test_every_config_is_reached_by_a_chip_smoke_case(self):
        smoke = _chip_smoke()
        for cases, suffix in ((smoke.CASES, ""), (smoke.F32_CASES, "_f32")):
            for kernel in fa.KERNELS:
                name = kernel + suffix
                reachable = {(fa.launch_config(tq, tk, d, name), d)
                             for d in fa.KERNEL_HEAD_DIMS
                             for tq in self.LENGTHS for tk in self.LENGTHS}
                reached = {(fa.launch_config(tq, tk, d, name), d)
                           for _, _, tq, tk, _, d, _, _ in cases if d in fa.KERNEL_HEAD_DIMS}
                assert reachable == reached, name
                # The wide instance at D = 512 (and at 768, with a slice of
                # 256 columns): its tiles (f32 K2 and K3: 32 rows of two
                # pairs up to T = 32, 64 beyond) at a short and a long
                # sequence, Tq != Tk, causal and key-padded, key 0.
                wide = [c for c in cases if c[5] not in fa.KERNEL_HEAD_DIMS]
                assert {512, 768} <= {c[5] for c in wide}
                assert {max(c[2], c[3]) <= 32 for c in wide} == {True, False}
                assert any(c[2] != c[3] for c in wide) and any(c[7] == "key0" for c in wide)
                assert {fa.launch_config(c[2], c[3], 512, kernel + fa.WIDE + suffix)
                        for c in wide} == set(fa.WIDE_TILES[kernel + fa.WIDE + suffix][:2])
        # The 3xTF32 instances' edges in f32: ragged inside the short
        # tile, one past its reach, Tq != Tk and the row that sees no key
        # at every width (16 and 64).
        f32_cases = [c for c in smoke.F32_CASES if c[5] in fa.KERNEL_HEAD_DIMS]
        for name in self.TF32_INSTANCES:
            short, _, short_up_to = fa.KERNEL_TILES[name, 64]
            widths = {t for d in fa.KERNEL_HEAD_DIMS for t in fa.KERNEL_TILES[name, d][:2]}

            def tile(c):
                return fa.launch_config(c[2], c[3], c[5], name)
            assert any(tile(c) == short and c[2] % short for c in f32_cases)
            assert any(max(c[2], c[3]) == short_up_to + 1 for c in f32_cases)
            assert {tile(c) for c in f32_cases if c[2] != c[3]} == widths == {16, 64}
            assert {tile(c) for c in f32_cases if c[7] == "key0"} == widths
        # Each width's edges: one past and below the short tile, Tq != Tk
        # inside the long one, and the row that sees no key in both.
        shapes = {c[0]: c for c in smoke.CASES}
        assert fa.launch_config(33, 33, 64) == 128 and "one_past_short" in shapes
        assert {c[7] for c in smoke.CASES if c[2] == 32 and c[3] == 32} >= {"key0", "tail"}
        assert any(c[2] != c[3] and fa.launch_config(c[2], c[3], c[5]) == 128
                   for c in smoke.CASES if c[5] in fa.KERNEL_HEAD_DIMS)
        # The TMA-fed K1 and K3 at each of their head dims: the bench shape,
        # Tq != Tk key-padded, ragged causal and the row that sees no key.
        for d in fa.TMA_HEAD_DIMS["flash_fwd" + fa.TMA]:
            tma = [c for c in smoke.CASES if c[5] == d and max(c[2], c[3]) > 32]
            assert any(c[1:4] == (4, 2048, 2048) and c[6] for c in tma), d
            assert any(c[2] != c[3] and c[7] == "tail" for c in tma), d
            assert any(c[6] and c[2] % 64 and c[7] == "tail" for c in tma), d
            assert any(c[7] == "key0" for c in tma), d


class TestChipSmokeKernelsLine:
    """chip_smoke.py's `{"kernels": [...]}` line, assembled on the CPU from
    stand-in records of its kernel cases and phases (the card fills the
    numbers): one row per kernel instance, the TMA-fed ones included, each
    with the contract's keys, its source in the repo and the Pallas kernel
    it replaces."""

    KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}

    @staticmethod
    def _record(fa, case, dtype, smoke):
        name, b, tq, tk, h, d, causal, mask = case
        record = {"case": name, "shape": [b, tq, tk, h, d], "causal": causal,
                  "dtype": str(dtype), "mask": mask, "kernels": {}, "by_kernel": {},
                  "library_fwd_ms": 1.0, "library_fwd_bwd_ms": 3.0, "library_bwd_ms": 2.0,
                  "library_bwd_by": "fwd_bwd - fwd", "library_backend": "FLASH_ATTENTION",
                  "flash_fwd_bwd_ms": 2.5}
        for key in ("fwd_max_abs", "lse_max_abs", "dq_max_rel", "dk_max_rel", "dv_max_rel",
                    "dq_max_abs", "dkv_max_abs", "delta_max_abs"):
            record[key] = 1e-3
        if name in smoke.DELTA_TIMED:
            iname = fa.DELTA + fa.KERNEL_DTYPES[dtype]
            record["by_kernel"][fa.DELTA] = iname
            record["kernels"][iname] = {"ms": 0.01, "plain_ms": 0.04, "bound_ms": 0.005,
                                        "bound_by": "bytes", "bytes": 1, "flops": 1,
                                        "tile": None}
            record["delta_library_ms"] = 0.02 if dtype == torch.float32 else None
        for kname in fa.KERNELS:
            iname = fa.instance(kname, dtype, d, tq, tk)
            record["by_kernel"][kname] = iname
            record["kernels"][iname] = {"ms": 0.5, "plain_ms": 5.0, "bound_ms": 0.1,
                                        "bound_by": "operations", "bytes": 1, "flops": 1,
                                        "tile": fa.launch_config(tq, tk, d, iname)}
        return record

    def test_the_bound_counts_each_visible_scores_exponential(self):
        """`work` gives K1, K2 and K3 one exponential per visible score
        (every causal pair by default; `visible_scores` from the mask and
        causality), delta none; at the bench shape 67.1 M, which at 16 a
        clock on 132 SMs at 1.98 GHz take 0.01605 ms, twice K1's ops
        bound at D = 32 and under it at D = 64."""
        smoke = _chip_smoke()
        from shockwave_tpu_torch.profiling import device
        exps = 4 * 8 * 2048 * 2049 // 2
        assert exps == 67_141_632
        w = smoke.work(4, 2048, 2048, 8, 32, True)
        assert [w[k][2] for k in ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")] == [
            exps, exps, exps, 0]
        rate = device.exp_rate(132, 1.98e9)
        assert exps / rate * 1e3 == pytest.approx(0.01605, rel=1e-3)
        assert exps / rate > 1.8 * w["flash_fwd"][1] / 989e12
        assert exps / rate < smoke.work(4, 2048, 2048, 8, 64, True)["flash_fwd"][1] / 989e12 * 1.1
        cpu = torch.device("cpu")
        assert smoke.visible_scores(None, 4, 8, 2048, 2048, True, cpu) == exps
        assert smoke.visible_scores(None, 2, 3, 5, 7, False, cpu) == 2 * 3 * 5 * 7
        mask = torch.ones(1, 4, dtype=torch.bool)
        mask[0, 0] = False  # key 0 masked: rows 0..3 see 0, 1, 2, 3 keys
        assert smoke.visible_scores(mask, 1, 2, 4, 4, True, cpu) == 2 * 6
        assert smoke.visible_scores(mask, 1, 2, 3, 4, False, cpu) == 2 * 3 * 3
        assert smoke.work(1, 4, 4, 2, 32, True, visible=12)["flash_dkv"][2] == 12

    def test_kernels_line_names_every_instance(self):
        smoke = _chip_smoke()
        cases = {c[0]: self._record(fa, c, torch.bfloat16, smoke) for c in smoke.CASES}
        cases.update({c[0]: self._record(fa, c, torch.float32, smoke) for c in smoke.F32_CASES})

        def launches(names, count):
            return {n: count if n in names else 0 for n in fa.LAUNCHES}

        sliced = {"launches": launches(fa.INSTANCES[:3] + fa.DELTA_INSTANCES[:1], 540)}
        served = {"decoder_flash_f32": {
            "launches": launches(fa.INSTANCES[3:6] + fa.DELTA_INSTANCES[1:], 2)}}
        for d in (128, 256, 512):
            served[f"decoder_flash_head_dim_{d}"] = {
                widths: {"shape": [8, 64], "launches": launches(
                    {fa.instance(k, dtype, d, 64, 64) for k in fa.KERNELS}, 2)}
                for widths, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
        served["decoder_flash_bf16"] = {"launches": launches(
            {fa.instance(k, torch.bfloat16, 32, 64, 64) for k in fa.KERNELS}, 2)}
        served["decoder_flash_f32_long"] = {
            f"head_dim_{d}": {"shape": [8, 128], "launches": launches(
                {fa.instance(k, torch.float32, d, 128, 128) for k in fa.KERNELS}, 2)}
            for d in fa.TMA_HEAD_DIMS["flash_fwd_f32" + fa.TMA]}
        profiled = {"launches": launches(
            {fa.instance(k, torch.bfloat16, 64, 2048, 2048) for k in fa.KERNELS}, 180)}
        rows = smoke.kernel_rows(fa, cases, sliced, served, profiled)
        assert sorted(r["name"] for r in rows) == sorted(fa.LAUNCHES)
        for row in rows:
            assert self.KEYS <= set(row), (row["name"], self.KEYS - set(row))
            assert os.path.exists(os.path.join(REPO, row["source"])), row
            assert row["replaces"].startswith("shockwave_tpu/ops/flash_attention.py:")
            assert row["route"] == "cuda" and row["launches"] > 0, row
        by_name = {r["name"]: r for r in rows}
        for name, launched in zip(fa.DELTA_INSTANCES, (540, 2)):  # on the main path's runs
            row = by_name[name]
            assert row["source"] == "shockwave_tpu_torch/csrc/flash_attention_delta.cu"
            assert row["launches"] == launched and row["bound_by"] == "bytes"
            assert {"bench_ms", "bench_plain_ms", "bench_bound_ms"} <= set(row)
        for name in fa.INSTANCES:  # head dim 32's long tile at the bench shape: bf16
            tile = fa.KERNEL_TILES[name, 32][1]  # K1's and K3's TMA-fed, K2's mma.sync
            assert by_name[name]["d32_bench_instance"] == fa.tile_instance(name, 32, tile)
            assert by_name[name]["d32_bench_tile"] == tile
        for name in ("flash_fwd_tma", "flash_dkv_tma"):  # and their own rows
            assert {"d32_bench_ms", "d32_bench_bound_ms", "d32_bench_plain_ms",
                    "d32_bench_library_ms"} <= set(by_name[name])
            assert by_name[name]["d32_decoder_launches"] == 2
        assert by_name["flash_dkv_tma"]["d32_bench_k2_k3_ms"] == 1.0
        assert "d32_bench_ms" not in by_name["flash_dq_tma"]
        for name in fa.TMA_INSTANCES:
            row = by_name[name]
            if "_f32" in name:  # f32: launched by the f32 decoder at T = 128
                assert row["source"] == "shockwave_tpu_torch/csrc/flash_attention_tma_f32.cu"
                assert row["launches"] == 6 and row["at"].startswith("bench_causal_f32")
            else:
                assert row["source"] == "shockwave_tpu_torch/csrc/flash_attention_tma.cu"
                assert row["launches"] == 180 and row["at"].startswith("bench_causal")
            assert {"d128_bench_ms", "d256_bench_ms"} <= set(row)
        assert by_name["flash_fwd_f32_tma"]["library_ms"] == 1.0
        for d in ("", "d128_", "d256_"):  # f32 K2 + K3 beside SDPA's backward at each D
            assert by_name["flash_dq_f32_tma"][f"{d}bench_k2_k3_ms"] == 1.0
        assert by_name["flash_fwd_tma"]["library_ms"] == 1.0
        assert by_name["flash_fwd"]["launches"] == 540 and "bench_ms" not in by_name["flash_fwd"]
        assert by_name["flash_dq"]["launches"] == 540 and "bench_ms" not in by_name["flash_dq"]
        assert by_name["flash_dq_tma"]["library_ms"] is None
        for d in ("", "d128_", "d256_"):  # K2 + K3 beside SDPA's backward at each D
            assert by_name["flash_dq_tma"][f"{d}bench_k2_k3_ms"] == 1.0
            assert by_name["flash_dq_tma"][f"{d}bench_library_bwd_ms"] == 2.0


class _RecordingLibrary:
    """Stands in for the kernel library: every entry point records its
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


class TestCInterface:
    """What each wrapper hands its C entry point, with the library, the
    device check and the stream replaced (there is no card here): as many
    arguments as `_build._ENTRY_POINTS` declares, each of the declared
    type (q, k, v, dO and the outputs as `View`s: base and strides), and
    `launch_config`'s tile right after the head dim."""

    ENTRY = {"fwd": "swt_flash_fwd", "dq": "swt_flash_dq", "dkv": "swt_flash_dkv"}

    @pytest.fixture
    def lib(self, monkeypatch):
        lib = _RecordingLibrary()
        monkeypatch.setattr(fa._build, "library", lambda: lib)
        monkeypatch.setattr(fa, "_on_cpu", lambda *tensors: False)
        monkeypatch.setattr(fa, "_device_and_stream", lambda t: (0, 0))
        fa.reset_launch_counts()
        yield lib
        fa.reset_launch_counts()

    @staticmethod
    def _check_types(name, args):
        argtypes = dict(fa._build._ENTRY_POINTS)[name]
        assert len(args) == len(argtypes), (name, len(args), len(argtypes))
        kinds = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: (int,),
                 ctypes.c_float: (float,), fa._build.View: (fa._build.View,)}
        for i, (arg, argtype) in enumerate(zip(args, argtypes)):
            assert isinstance(arg, kinds[argtype]) and not isinstance(arg, bool), (name, i, arg)

    @pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
    @pytest.mark.parametrize("tq,tk", [(32, 32), (33, 33), (32, 48)])
    def test_wrapper_hands_over_the_declared_arguments(self, lib, kernel, tq, tk, d=64):
        bh, heads = 4, 2
        q, g = (torch.zeros(bh, tq, d, dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.zeros(bh, tk, d, dtype=torch.bfloat16) for _ in range(2))
        lse, delta = (torch.zeros(bh, tq) for _ in range(2))
        mask = torch.ones(bh // heads, tk, dtype=torch.bool)
        causal = tq == tk
        if kernel == "fwd":
            fa.attention_forward(q, k, v, mask, heads, 0.125, causal)
        elif kernel == "dq":
            fa.attention_dq(q, k, v, g, lse, delta, mask, heads, 0.125, causal)
        else:
            fa.attention_dkv(q, k, v, g, lse, delta, mask, heads, 0.125, causal)
        [(name, args)] = lib.calls
        instance = fa.instance(f"flash_{kernel}", torch.bfloat16, d, tq, tk)
        assert name == "swt_" + instance.removesuffix(fa.TMA)  # a TMA instance: its base's
        self._check_types(name, args)
        assert fa.LAUNCHES[instance] == 1
        # ..., bh, heads, tq, tk, d, tile, scale, causal, device, stream
        assert args[-10:-4] == (bh, heads, tq, tk, d, fa.launch_config(tq, tk, d, instance))
        assert args[-4:] == (0.125, int(causal), 0, 0)

    @pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
    @pytest.mark.parametrize("tq,tk", [(32, 32), (33, 33), (32, 48)])
    def test_wrapper_hands_over_the_declared_arguments_at_d128(self, lib, kernel, tq, tk):
        self.test_wrapper_hands_over_the_declared_arguments(lib, kernel, tq, tk, d=128)

    @pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
    @pytest.mark.parametrize("tq,tk", [(32, 32), (33, 33), (32, 48)])
    def test_wrapper_hands_over_the_declared_arguments_at_d256(self, lib, kernel, tq, tk):
        self.test_wrapper_hands_over_the_declared_arguments(lib, kernel, tq, tk, d=256)

    @pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
    @pytest.mark.parametrize("tq,tk", [(32, 32), (33, 33), (32, 48)])
    def test_wrapper_hands_over_the_declared_arguments_at_d512(self, lib, kernel, tq, tk):
        """The wide instances' entry points (d = 512 and 768)."""
        self.test_wrapper_hands_over_the_declared_arguments(lib, kernel, tq, tk, d=512)
        lib.calls.clear()
        fa.reset_launch_counts()
        self.test_wrapper_hands_over_the_declared_arguments(lib, kernel, tq, tk, d=768)

    @pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
    @pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, ""), (torch.float32, "_f32")])
    def test_each_dtype_reaches_its_own_instance(self, lib, kernel, dtype, suffix):
        """bf16 inputs reach the bf16 kernel, f32 inputs the f32 one, with
        the same arguments, and only that instance's counter moves."""
        bh, heads, t, d = 4, 2, 48, 32
        q, k, v, g = (torch.zeros(bh, t, d, dtype=dtype) for _ in range(4))
        lse, delta = (torch.zeros(bh, t) for _ in range(2))
        if kernel == "fwd":
            out, lse_out = fa.attention_forward(q, k, v, None, heads, 0.25, True)
            assert out.dtype == dtype and lse_out.dtype == torch.float32
        elif kernel == "dq":
            assert fa.attention_dq(q, k, v, g, lse, delta, None, heads, 0.25,
                                   True).dtype == dtype
        else:
            dk, dv = fa.attention_dkv(q, k, v, g, lse, delta, None, heads, 0.25, True)
            assert dk.dtype == dv.dtype == dtype
        [(name, args)] = lib.calls
        assert name == self.ENTRY[kernel] + suffix
        self._check_types(name, args)
        # T = 48: the 3xTF32 instances take their one-warp tile, the bf16
        # ones their long tile: K1's and K3's TMA-fed 128 rows, K2's 64.
        tile = 16 if suffix else 64 if kernel == "dq" else 128
        assert args[-10:] == (bh, heads, t, t, d, tile, 0.25, 1, 0, 0)
        instance = fa.instance(f"flash_{kernel}", dtype, d, t, t)
        assert instance == f"flash_{kernel}{suffix}" + ("" if suffix or kernel == "dq" else fa.TMA)
        assert {n: c for n, c in fa.LAUNCHES.items() if c} == {instance: 1}

    @pytest.mark.parametrize("dtypes", [(torch.float16,) * 3, (torch.float64,) * 3,
                                        (torch.bfloat16, torch.float32, torch.bfloat16)])
    def test_other_dtypes_raise_naming_both(self, lib, dtypes):
        q, k, v = (torch.zeros(2, 32, 64, dtype=dt) for dt in dtypes)
        with pytest.raises(TypeError, match=r"takes torch\.bfloat16 or torch\.float32"):
            fa.attention_forward(q, k, v, None, 1, 0.125, False)
        assert lib.calls == [] and not any(fa.LAUNCHES.values())

    def test_occupancy_asks_for_every_kernel_at_both_tiles(self, lib):
        rows = fa.kernel_occupancy(device=0)
        asked = set()
        for name, args in lib.calls:
            assert name == "swt_flash_occupancy"
            self._check_types(name, args[:-1] + (0,))  # `out` is a ctypes array
            asked.add(args[:3])
        assert asked == {(kernel, d, tile) for kernel, name in enumerate(fa.INSTANCES)
                         for d in fa.KERNEL_HEAD_DIMS for tile in fa.KERNEL_TILES[name, d][:2]} | {
            (kernel, 512, tile) for kernel, name in enumerate(fa.LAUNCHES)
            if name in fa.WIDE_INSTANCES for tile in fa.WIDE_TILES[name][:2]}
        assert list(fa.LAUNCHES) == list(fa.INSTANCES + fa.WIDE_INSTANCES + fa.TMA_INSTANCES
                                         + fa.DELTA_INSTANCES)
        assert {(r["kernel"], r["tile"]) for r in rows if r["d"] == 512} == {
            (name, tile) for name in fa.WIDE_INSTANCES for tile in fa.WIDE_TILES[name][:2]}
        assert {(r["kernel"], r["d"], r["tile"]) for r in rows} >= {
            ("flash_dq", d, 32) for d in (32, 64, 128, 256)} | {("flash_dq", 32, 64)}
        for d in (128, 256):  # the long tiles of K1-K3 in bf16 are the TMA instances'
            assert {(r["kernel"], r["tile"]) for r in rows if r["d"] == d} == {
                (fa.tile_instance(name, d, tile), tile) for name in fa.INSTANCES
                for tile in fa.KERNEL_TILES[name, d][:2]}
            assert {("flash_fwd_tma", 128), ("flash_dq_tma", 128),
                    ("flash_dkv_tma", 128 if d == 128 else 64)} <= {
                (r["kernel"], r["tile"]) for r in rows if r["d"] == d}
        for d in (128, 256):  # f32: K1's-K3's long tile TMA-fed
            assert {(r["kernel"], r["tile"]) for r in rows
                    if "_f32" in r["kernel"] and r["d"] == d} == {
                ("flash_fwd_f32", 16), ("flash_fwd_f32_tma", 64), ("flash_dq_f32", 16),
                ("flash_dq_f32_tma", 64), ("flash_dkv_f32", 16), ("flash_dkv_f32_tma", 64)}

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("d,width", [(16, 32), (48, 64), (80, 128), (96, 128), (128, 128),
                                         (160, 256), (256, 256), (320, 512), (600, 768)])
    def test_flash_attention_hands_the_kernels_the_padded_width(self, lib, d, width, dtype):
        """On the card's path `flash_attention` gives every kernel q, k, v
        and dO zero-padded to `kernel_head_dim(d)`, and the kernels' head
        dim is that width; the output and gradients come back at d."""
        b, t, h = 2, 48, 2
        q, k, v = (torch.randn(b, t, h, d, dtype=dtype, requires_grad=True) for _ in range(3))
        out = fa.flash_attention(q, k, v, causal=True)
        assert out.shape == (b, t, h, d) and out.dtype == dtype
        out.backward(torch.ones_like(out))
        assert [x.grad.shape for x in (q, k, v)] == [(b, t, h, d)] * 3
        instances = [fa.instance(f"flash_{kernel}", dtype, width, t, t)
                     for kernel in ("fwd", "dq", "dkv")]
        delta = fa.DELTA + fa.KERNEL_DTYPES[dtype]  # between K1 and K2
        assert [name for name, _ in lib.calls] == ["swt_" + i.removesuffix(fa.TMA)
                                                   for i in instances[:1] + [delta]
                                                   + instances[1:]]
        self._check_types(*lib.calls.pop(1))
        for (name, args), instance in zip(lib.calls, instances):
            self._check_types(name, args)
            tile = fa.launch_config(t, t, width, instance)
            # T = 48: past the reach of every wide instance's short tile
            # but K1's (one tile of 64); in bf16 K1-K3 at 64-256 take
            # their TMA-fed instances' tiles.
            assert tile == (fa.WIDE_TILES[instance][1] if width > 256
                            else 16 if dtype == torch.float32
                            else fa.KERNEL_TILES[instance, width][1] if fa.TMA in instance
                            else 64)
            assert fa.LAUNCHES[instance] == 1
            assert args[-10:-4] == (b * h, h, t, t, width, tile)
            assert args[-4:-2] == (pytest.approx(1.0 / math.sqrt(d)), 1)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("d", [257, 320])
    def test_head_dims_above_128_raise_naming_the_item_that_lifts_them(self, lib, d, dtype):
        """Above the widest template instance (256; the name dates from
        when head dims above 128 raised) a head dim no longer raises: it
        pads to 512 and reaches the wide instances' launch config, forward
        and backward, and only their counters move."""
        q = torch.zeros(1, 32, 2, d, dtype=dtype, requires_grad=True)
        fa.flash_attention(q, q, q).sum().backward()
        suffix = fa.KERNEL_DTYPES[dtype]
        names = [f"flash_{k}{fa.WIDE}{suffix}" for k in ("fwd", "dq", "dkv")]
        delta = fa.DELTA + suffix
        assert [name for name, _ in lib.calls] == ["swt_" + n for n in
                                                   names[:1] + [delta] + names[1:]]
        self._check_types(*lib.calls.pop(1))
        for (name, args), instance in zip(lib.calls, names):
            self._check_types(name, args)
            assert args[-10:-4] == (2, 2, 32, 32, 512, fa.WIDE_TILES[instance][0])
            # The wide instances too take the padded (B, T, H, D) tensors
            # in place: rows H D apart.
            for view in (a for a in args if isinstance(a, fa._build.View)):
                assert (view.s.b, view.s.h, view.s.t) == (32 * 2 * 512, 512, 2 * 512)
        assert {n: c for n, c in fa.LAUNCHES.items() if c} == dict.fromkeys(names + [delta], 1)

    @pytest.mark.parametrize("d", [16, 32])
    def test_head_dim_32_reaches_tma_k1_and_k3(self, lib, d):
        """bf16 at d = 32, and d = 16 padded to 32, at T = 64: the forward +
        backward launches the TMA-fed K1 (tile 128) through swt_flash_fwd,
        delta, K2's mma.sync instance (tile 64) and the TMA-fed K3 (tile
        128) through swt_flash_dkv, once each, at width 32."""
        b, t, h = 2, 64, 2
        q, k, v = (torch.zeros(b, t, h, d, dtype=torch.bfloat16, requires_grad=True)
                   for _ in range(3))
        fa.flash_attention(q, k, v, causal=True).sum().backward()
        assert [name for name, _ in lib.calls] == ["swt_flash_fwd", "swt_flash_bwd_delta",
                                                   "swt_flash_dq", "swt_flash_dkv"]
        for (name, args), tile in zip(lib.calls[:1] + lib.calls[2:], (128, 64, 128)):
            self._check_types(name, args)
            assert args[-10:-4] == (b * h, h, t, t, 32, tile)
        assert {n: c for n, c in fa.LAUNCHES.items() if c} == {
            "flash_fwd_tma": 1, "flash_bwd_delta": 1, "flash_dq": 1, "flash_dkv_tma": 1}

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("t", [32, 48])
    def test_model_layout_reaches_the_kernels_in_place(self, lib, dtype, t):
        """With the model's own (B, T, H, D) tensors at d = the kernel width,
        K1 gets q's, k's and v's own bases with rows H D apart and writes
        the output into the tensor `flash_attention` returns; delta, K2 and
        K3 read that output and the incoming gradient in place, and write
        dQ, dK and dV into the tensors the gradients come back in. Nothing
        is copied on the way in or out."""
        b, h, d = 2, 4, 64
        q, k, v = (torch.zeros(b, t, h, d, dtype=dtype, requires_grad=True) for _ in range(3))
        out = fa.flash_attention(q, k, v, causal=True)
        fwd_args = lib.calls[0][1]
        views = [a for a in fwd_args if isinstance(a, fa._build.View)]
        assert [x.data for x in views] == [x.data_ptr() for x in (q, k, v, out)]
        for x in views:
            assert (x.s.b, x.s.h, x.s.t) == (t * h * d, d, h * d)
        assert out.is_contiguous() and out.shape == (b, t, h, d)
        g = torch.zeros(b, t, h, d, dtype=dtype)
        grads = torch.autograd.grad(out.reshape(b, t, h * d), (q, k, v),
                                    g.reshape(b, t, h * d))
        (_, delta_args), (_, dq_args), (_, dkv_args) = lib.calls[1:]
        assert [delta_args[0].data, delta_args[1].data] == [out.data_ptr(), g.data_ptr()]
        dq_views = [a for a in dq_args if isinstance(a, fa._build.View)]
        dkv_views = [a for a in dkv_args if isinstance(a, fa._build.View)]
        assert [x.data for x in dq_views] == [x.data_ptr() for x in (q, k, v, g, grads[0])]
        assert [x.data for x in dkv_views] == [x.data_ptr() for x in (q, k, v, g, *grads[1:])]
        for grad in grads:
            assert grad.is_contiguous() and grad.shape == (b, t, h, d)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_a_misaligned_view_reaches_the_kernel_as_a_copy(self, lib, dtype):
        """A view whose rows are not 16 bytes apart (here d + 1 elements)
        breaks the rule of cp.async and TMA: the wrapper hands the kernel
        a packed copy, and hands aligned views of other tensors as they
        are."""
        b, h, t, d = 1, 2, 48, 64
        base = torch.zeros(b, h, t, d + 1, dtype=dtype)
        q = base[..., :d]  # rows d + 1 apart
        k, v = (torch.zeros(b, t, h, d, dtype=dtype).transpose(1, 2) for _ in range(2))
        assert not fa._fits(q) and fa._fits(k)
        fa.attention_forward(q, k, v, None, h, 0.125, True)
        views = [a for a in lib.calls[0][1] if isinstance(a, fa._build.View)]
        assert views[0].data != q.data_ptr()
        assert (views[0].s.b, views[0].s.h, views[0].s.t) == (h * t * d, t * d, d)
        assert [views[1].data, views[2].data] == [k.data_ptr(), v.data_ptr()]
        for misaligned in (base[..., 1:d + 1], torch.zeros(b, h, t, d, 2, dtype=dtype)[..., 0]):
            assert not fa._fits(misaligned)  # an odd base; columns not at stride 1
            lib.calls.clear()
            fa.attention_forward(misaligned, k, v, None, h, 0.125, True)
            assert lib.calls[0][1][0].data != misaligned.data_ptr()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (finite f32) rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to
    10 mantissa bits, to nearest, ties away from zero, by integer ops on
    its int32 view (adding half of the dropped 13 bits rounds the
    magnitude; the mask drops them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x with the 13 bits below TF32's mantissa cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def matmul_tf32(a, b, passes: int, split: str = "rna"):
    """a @ b as the tensor cores run it on TF32 operands: one pass
    (big.big, operands rounded) or three (3xTF32: x = big + small,
    small.big + big.small, then big.big, summed in f32). The split is
    "rna" (both parts rounded as cvt.rna rounds them) or "kernel" (the
    f32 kernels' split_tf32: big truncated, small rounded to nearest)."""
    if passes == 1:
        return tf32_round(a) @ tf32_round(b)
    parts = []
    for x in (a, b):
        big = tf32_round(x) if split == "rna" else tf32_truncate(x)
        parts.append((big, tf32_round(x - big)))
    (a_big, a_small), (b_big, b_small) = parts
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


class TestThreeTf32Premise:
    """The f32 kernels' design rests on 3xTF32 keeping the plain f32
    versions' digits where one-pass TF32 does not. One causal head (T 256,
    D 64, seeded unit-normal inputs) runs through the forward (and K3's
    four backward products) with the products emulated on TF32 operands,
    against float64: 3xTF32 must stay within 1e-5, under chip_smoke.py's
    F32_TOL of 1e-4, like the plain f32 path, with both parts rounded as
    cvt.rna rounds them and with the kernels' own split, while one-pass
    TF32 must miss 1e-4, which is why the kernels split every operand."""

    T, D = 256, 64

    def _inputs(self):
        rng = np.random.RandomState(0)
        return [torch.from_numpy(rng.randn(self.T, self.D).astype(np.float32))
                for _ in range(4)]

    def _forward(self, q, k, v, matmul):
        s = matmul(q, k.T) / math.sqrt(self.D)
        s = torch.where(torch.ones_like(s, dtype=torch.bool).tril(), s, -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return matmul(p, v) / p.sum(-1, keepdim=True), p / p.sum(-1, keepdim=True)

    def _dkv(self, q, k, v, g, p, matmul):
        """dK and dV as K3 forms them from its four products."""
        dv = matmul(p.T, g)
        dp = matmul(v, g.T).T  # dP^T = V.dO^T
        out = matmul(p, v)
        ds = p * (dp - (g * out).sum(-1, keepdim=True)) / math.sqrt(self.D)
        return matmul(ds.T, q), dv

    def _errors(self, run, split):
        q, k, v, g = self._inputs()
        ref = run(*(x.double() for x in (q, k, v, g)), lambda a, b: a @ b)
        errs = {}
        for label, matmul in (("f32", lambda a, b: a @ b),
                              ("3xtf32", lambda a, b: matmul_tf32(a, b, 3, split)),
                              ("tf32", lambda a, b: matmul_tf32(a, b, 1))):
            got = run(q, k, v, g, matmul)
            errs[label] = max(float((x.double() - r).abs().max()) for x, r in zip(got, ref))
        return errs

    def test_rounding_is_cvt_rna(self):
        one_ulp = 2.0 ** -10
        x = torch.tensor([1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2.0 ** -20,
                          -(1.0 + one_ulp / 2), 3.0 + 1.5 * one_ulp * 2])
        assert tf32_round(x).tolist() == [1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 3.0 + 4 * one_ulp]

    @pytest.mark.parametrize("split", ["rna", "kernel"])
    def test_forward(self, split):
        errs = self._errors(lambda q, k, v, g, mm: self._forward(q, k, v, mm)[:1], split)
        assert errs["f32"] <= 1e-5 and errs["3xtf32"] <= 1e-5, errs
        assert errs["tf32"] > 1e-4, errs

    @pytest.mark.parametrize("split", ["rna", "kernel"])
    def test_dkv_products(self, split):
        def run(q, k, v, g, mm):
            _, p = self._forward(q, k, v, lambda a, b: a @ b)
            return self._dkv(q, k, v, g, p, mm)
        errs = self._errors(run, split)
        assert errs["f32"] <= 1e-5 and errs["3xtf32"] <= 1e-5, errs
        assert errs["tf32"] > 1e-4, errs
