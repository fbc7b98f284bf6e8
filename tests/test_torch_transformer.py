"""The port's Seq2SeqTransformer against the flax model, on the CPU.

Weights go across through `shockwave_tpu_torch.convert`; the same numpy
token batch (with padded tails) goes into both. The JAX flash path runs
its Pallas kernels in interpret mode; the port's takes the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu.models.transformer import Seq2SeqTransformer as FlaxSeq2Seq
from shockwave_tpu_torch.convert import flax_to_state_dict
from shockwave_tpu_torch.models.transformer import (LayerNorm,
                                                    Seq2SeqTransformer,
                                                    sinusoidal_positions)

KW = dict(vocab_size=64, dim=64, num_heads=2, num_layers=2, mlp_dim=128,
          max_len=32)
# f32: TestTransformerFlashPath's tolerance. bf16: both round every
# dense output, the attention weights and the MLP activation to bf16
# (relative step 2^-8 = 3.9e-3) in their own order, through 2 + 2 layers,
# on logits of magnitude ~0.45; 1e-2 is about 2.5 such steps of the
# largest logit (measured: 2.9e-3).
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests share the machine with the rest of the suite's workers
    (some of them timing-sensitive loopbacks); their tensors are tiny, so
    one intra-op thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tokens(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(1, 64, (2, 32)).astype(np.int32)
    tgt = rng.randint(1, 64, (2, 32)).astype(np.int32)
    src[0, 20:] = 0
    tgt[1, 25:] = 0
    return src, tgt


def flax_params(src, tgt, dtype=jnp.float32):
    model = FlaxSeq2Seq(**KW, dtype=dtype)
    params = model.init(jax.random.PRNGKey(0), src, tgt)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype,use_flash", [("float32", False),
                                             ("float32", True),
                                             ("bfloat16", True)])
def test_logits_match_flax(dtype, use_flash):
    jdt, tdt = DTYPES[dtype]
    src, tgt = tokens()
    params = flax_params(src, tgt, jdt)
    ref = np.asarray(FlaxSeq2Seq(**KW, dtype=jdt, use_flash=use_flash).apply(
        {"params": params}, src, tgt))
    port = Seq2SeqTransformer(**KW, dtype=tdt, use_flash=use_flash)
    port.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        out = port(torch.from_numpy(src).long(), torch.from_numpy(tgt).long())
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max()
    assert err < TOL[dtype], err


def test_flash_matches_einsum_path():
    """TestTransformerFlashPath's check, on the port alone."""
    src, tgt = (torch.from_numpy(x).long() for x in tokens(5))
    kwargs = dict(KW, num_layers=1, mlp_dim=64, dtype=torch.float32)
    base = Seq2SeqTransformer(use_flash=False, **kwargs)
    flash = Seq2SeqTransformer(use_flash=True, **kwargs)
    flash.load_state_dict(base.state_dict())
    with torch.no_grad():
        err = (base(src, tgt) - flash(src, tgt)).abs().max().item()
    assert err < 1e-4, err


def test_converter_consumes_every_leaf():
    src, tgt = tokens()
    params = flax_params(src, tgt)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    sd = flax_to_state_dict(params)
    assert len(sd) == n_leaves
    port = Seq2SeqTransformer(**KW, dtype=torch.float32)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)


def test_converter_rejects_missing_and_left_over_leaves():
    src, tgt = tokens()
    params = flax_params(src, tgt)
    missing = jax.tree_util.tree_map(lambda x: x, params)
    del missing["dec_1"]["cross_attn"]["value"]["bias"]
    with pytest.raises(KeyError, match="dec_1/cross_attn/value/bias"):
        flax_to_state_dict(missing)
    extra = jax.tree_util.tree_map(lambda x: x, params)
    extra["enc_0"]["LayerNorm_2"] = {"scale": np.ones(64, np.float32)}
    with pytest.raises(ValueError, match="LayerNorm_2"):
        flax_to_state_dict(extra)


def test_layer_norm_matches_flax():
    import flax.linen as nn
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 64) * 3 + 1).astype(np.float32)
    ref = np.asarray(nn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": np.full(64, 1.5, np.float32),
                    "bias": np.full(64, 0.25, np.float32)}}, x))
    ln = LayerNorm(64)
    with torch.no_grad():
        ln.weight.fill_(1.5)
        ln.bias.fill_(0.25)
        out = ln(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() < 1e-5


def test_initialisation_follows_flax_distributions():
    # The published widths (fan-ins 512 and 2048), one layer each side.
    small = dict(vocab_size=256, num_layers=1)
    model = Seq2SeqTransformer(**small, generator=torch.Generator().manual_seed(1))
    emb = model.shared_embedding.weight
    assert abs(emb.std().item() - 0.02) < 1e-3
    for layer, fan_in in ((model.enc[0].self_attn.query, 512),
                          (model.dec[0].mlp[1], 2048)):
        w = layer.weight
        std = (1.0 / fan_in) ** 0.5
        assert abs(w.std().item() - std) / std < 0.02
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
        assert torch.count_nonzero(layer.bias) == 0
    again = Seq2SeqTransformer(**small, generator=torch.Generator().manual_seed(1))
    assert torch.equal(again.dec[0].mlp[0].weight, model.dec[0].mlp[0].weight)
    assert np.array_equal(model.positions.numpy(), sinusoidal_positions(64, 512))
