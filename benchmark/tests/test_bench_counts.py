"""The work counts against hand counts at small shapes: attention's
visible scores, bytes, FLOPs and exponentials with causal and key-padded
rows; the Transformer's and ResNet-50's model FLOPs."""
import json
import os

import pytest
import torch

from benchmark import counts
from benchmark.drivers import resnet, seq2seq_transformer

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK = torch.tensor([[True, True, False], [True, False, False]])


def test_visible_scores_by_hand():
    # without causality: every query row sees its row's real keys (2 and 1)
    assert counts.visible_scores(MASK, 2, 2, 3, 3, False, "cpu") == 2 * 3 * (2 + 1)
    # causal: row i sees the real keys <= i: (1, 2, 2) and (1, 1, 1)
    assert counts.visible_scores(MASK, 2, 2, 3, 3, True, "cpu") == 2 * (5 + 3)
    assert counts.visible_scores(None, 2, 2, 3, 3, True, "cpu") == 2 * 2 * 6
    assert counts.visible_scores(None, 2, 2, 3, 4, False, "cpu") == 2 * 2 * 12


def test_work_by_hand():
    b, h, t, d = 2, 2, 3, 4
    vis = counts.visible_scores(MASK, b, h, t, t, True, "cpu")  # 16
    w = counts.work(b, t, t, h, d, True, visible=vis)
    qkv = b * h * t * d * 2  # one (B, H, T, D) bf16 tensor: 96 bytes
    rows, mask = b * h * t * 4, b * t  # f32 row statistics, a byte a key
    assert w["flash_fwd"] == (2 * qkv + 2 * qkv + rows + mask, 4 * 16 * d, 16)
    assert w["flash_dq"] == (3 * qkv + 2 * qkv + 2 * rows + mask, 6 * 16 * d, 16)
    assert w["flash_dkv"] == (2 * qkv + 4 * qkv + 2 * rows + mask, 8 * 16 * d, 16)
    assert w["flash_bwd_delta"] == (2 * qkv + rows, 2 * b * h * t * d, 0)
    # key-padded rows count only their visible keys, not T x T
    assert counts.work(b, t, t, h, d, False, visible=12)["flash_fwd"][1] == 4 * 12 * d


def test_least_seconds_takes_the_largest_bound():
    calls = [(2, 3, 3, 2, 4, True, MASK)]
    w = counts.work(2, 3, 3, 2, 4, True, visible=16)
    for rates in ((1.0, 1e30, 1e30), (1e30, 1.0, 1e30), (1e30, 1e30, 1.0)):
        expect = sum(max(x / r for x, r in zip(v, rates)) for v in w.values())
        assert counts.least_seconds(calls, rates) == pytest.approx(expect)


def test_transformer_flops_by_hand():
    cfg = {"d_model": 2, "d_ff": 3, "num_layers": 1, "vocab_size": 5, "num_heads": 1}
    ls, lt = 2, 1  # one pair: 2 source tokens, 1 target token
    d, ff, v = 2, 3, 5
    gemm = lambda m, k, n: 2 * m * k * n  # noqa: E731
    enc = 4 * gemm(ls, d, d) + gemm(ls, d, ff) + gemm(ls, ff, d) + 2 * gemm(ls, d, ls)
    dec = (4 * gemm(lt, d, d) + gemm(lt, d, ff) + gemm(lt, ff, d)
           + 2 * gemm(lt, d, d) + 2 * gemm(ls, d, d)  # cross: q, out on the target; k, v on the source
           + 2 * 2 * d * (lt * (lt + 1) // 2)  # causal self attention, q.k and p.v
           + 2 * gemm(lt, d, ls))  # cross attention
    logits = gemm(lt, d, v)
    want = 3 * (enc + dec + logits)
    got = seq2seq_transformer.model_flops(cfg, {"src": [ls], "tgt": [lt], "t": 4})
    assert got == want


def test_transformer_attention_calls():
    cfg = {"d_model": 8, "num_heads": 2, "num_layers": 3}
    calls = seq2seq_transformer.attention_calls(cfg, {"src": [2, 3], "tgt": [1, 3], "t": 3})
    assert len(calls) == 9  # self + (self, cross) in each of 3 layers
    assert sum(c[5] for c in calls) == 3  # the decoder's self attention is causal
    dec_self = next(c for c in calls if c[5])
    # the decoder input holds the start token and the target: min(lt + 1, t)
    assert dec_self[6].sum(1).tolist() == [2, 3]


def test_resnet50_macs():
    """ResNet-50 at 224 x 224: 4.09 GMACs a forward pass (the count
    usually cited for the bottleneck with its stride on the 3x3)."""
    with open(os.path.join(HERE, "configs", "resnet50.json")) as f:
        cfg = json.load(f)
    stem, total = resnet._conv_macs(cfg, 224, 224)
    assert stem == 112 * 112 * 64 * 3 * 49
    assert total == pytest.approx(4.09e9, rel=0.01)
    assert resnet.model_flops(cfg, {"hw": (224, 224), "b": 2}) == 2 * 2 * (3 * total - 2 * stem)
