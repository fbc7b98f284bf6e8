"""The traffic generator: reproducible from the seed, the same sizes on
every seed, and the token budget and bucket shapes the mixes state."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import generator

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = {"vocab_size": 37000}
# (rows, length) of each token mix, every row full
SHAPES = {"doc2048": (12, 2048), "multi30k_b768": (768, 32)}


def mix(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


# a bucketed mix with padded rows, as a later mix may state one
BUCKETED = {"kind": "token_pairs", "buckets": [[8, 6], [16, 3]],
            "source_length": {"law": "uniform", "low": 2, "high": 16},
            "sizes_seed": 0, "population": 400, "pool_batches": 8}


@pytest.mark.parametrize("name", sorted(SHAPES) + ["bucketed"])
def test_same_seed_same_tokens(name):
    m = BUCKETED if name == "bucketed" else mix(name)
    a = generator.make(m, VOCAB, 2**31 + 11, "cpu")
    b = generator.make(m, VOCAB, 2**31 + 11, "cpu")
    c = generator.make(m, VOCAB, 2**31 + 12, "cpu")
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p.tensors, q.tensors))
    assert not all(torch.equal(p.tensors[0], q.tensors[0]) for p, q in zip(a, c))
    # every seed runs the same sizes, in another order
    assert sum(p.count for p in a) == sum(p.count for p in c)
    assert sorted(p.shape for p in a) == sorted(p.shape for p in c)
    for side in ("src", "tgt"):
        assert sorted(np.concatenate([p.lengths[side] for p in a])) == sorted(
            np.concatenate([p.lengths[side] for p in c]))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_token_budget_and_shapes(name):
    """Full rows of src (B, T) and tgt (B, T + 1), no pad id, as
    `data.multi30k`'s batches, 24,576 tokens a side."""
    b, t = SHAPES[name]
    pool = generator.make(mix(name), VOCAB, 7, "cpu")
    assert len(pool) == mix(name)["pool_batches"] >= 3
    for p in pool:
        src, tgt = p.tensors
        assert p.shape == (b, t) and src.shape == (b, t) and tgt.shape == (b, t + 1)
        assert int(src.min()) >= 1 and int(tgt.min()) >= 1
        assert int(src.max()) < VOCAB["vocab_size"] and int(tgt.max()) < VOCAB["vocab_size"]
        assert p.count == b * t == int((tgt[:, 1:] != 0).sum())  # what loss_fn counts
        assert list(p.lengths["src"]) == list(p.lengths["tgt"]) == [t] * b
    assert len({tuple(p.tensors[0][0, :4].tolist()) for p in pool}) == len(pool)
    assert b * t == 24576


def test_padded_rows_are_prefixes():
    pool = generator.make(BUCKETED, VOCAB, 3, "cpu")
    for p in pool:
        src, tgt = p.tensors
        b, t = p.shape
        real = tgt != 0
        ls, lt = (src != 0).sum(1), real.sum(1) - 1
        assert np.array_equal(ls.numpy(), p.lengths["src"])
        assert np.array_equal(lt.numpy(), p.lengths["tgt"])
        assert p.count == int((tgt[:, 1:] != 0).sum())
        # real tokens first, pad (0) after: a prefix in every row
        assert torch.equal(real, torch.arange(t + 1)[None, :] <= lt[:, None])
        assert int(torch.maximum(ls, lt).max()) <= t and int(ls.min()) >= 2


def test_buckets_follow_tokens():
    """Each bucket's share of the batches follows the tokens in it, and
    a batch holds only pairs that need its bucket."""
    plan = generator.bucket_plan(BUCKETED)
    assert [(t, b) for t, b, *_ in plan] == [(8, 6), (16, 3)]
    assert sum(n for _, _, n, _, _ in plan) == 8
    edges = [0, 8, 16]
    for i, (t, b, n, src, tgt) in enumerate(plan):
        assert len(src) == n * b and src.max() <= t and src.min() > edges[i]
        assert np.array_equal(src, tgt)
    # lengths uniform in [2, 16]: the longer bucket holds about 8/15 of the
    # pairs and more of the tokens
    assert plan[1][2] > plan[0][2] >= 1


def test_images():
    m = dict(mix("imagenet_b128"), batch=4, height=8, width=8, pool_batches=2)
    a = generator.make(m, {}, 5, "cpu")
    b = generator.make(m, {}, 5, "cpu")
    images, labels = a[0].tensors
    assert images.shape == (4, 8, 8, 3) and images.dtype == torch.float32
    assert float(images.min()) >= 0 and float(images.max()) < 1
    assert int(labels.min()) >= 0 and int(labels.max()) < 1000 and a[0].count == 4
    assert torch.equal(images, b[0].tensors[0])
