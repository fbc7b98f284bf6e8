"""The one traffic generator: a pool of device-resident training batches
from a mix's parameters (`benchmark/traffic/<name>.json`) and `--seed`.

A mix fixes the set of sizes; the seed draws the order and the tokens or
pixels. So every seed runs the same work, and runs with different seeds
differ no more than runs of one seed do. The pool is cycled by the
window, as a synthetic loader hands a job the same batch again and
again, and nothing is copied from the host inside it.

Two kinds:

- `token_pairs`: translation batches of (src, tgt) token arrays, pad id
  0, tokens drawn from 1 .. vocab_size - 1. A pair's source length
  follows `source_length` (`fixed` at `length`, every row full, or
  `uniform` between `low` and `high`), and its target length is the
  source's. A pair falls in the smallest bucket (T, B) whose T holds both
  sides; its batch is B pairs, src (B, T) and tgt (B, T + 1), whose
  first target token starts the sequence, so the loss counts the target
  length. Each bucket gets a share of the pool's batches in proportion
  to the tokens that fall in it (at least one batch each). The lengths
  are drawn from `sizes_seed`, the mix's own, and the run's seed
  shuffles them over the rows.
- `images`: batches of `batch` NHWC float32 images, uniform in [0, 1),
  and labels in [0, classes).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .weights import derive


@dataclass
class Batch:
    tensors: tuple       # what `Trainer.train_step` takes, on the device
    count: int           # the work it completes: target tokens or images
    shape: tuple         # the padded shape, one warm-up per shape
    lengths: dict = field(default_factory=dict)  # host-side lengths, for work counts


def make(mix: dict, cfg: dict, seed: int, device) -> list:
    """The pool of batches of `mix` for the model `cfg`."""
    kinds = {"token_pairs": _token_pairs, "images": _images}
    return kinds[mix["kind"]](mix, cfg, seed, device)


def _lengths(law: dict, rng, n: int):
    if law["law"] == "fixed":
        src = np.full(n, law["length"], dtype=np.int64)
    elif law["law"] == "uniform":
        src = rng.integers(law["low"], law["high"] + 1, size=n).astype(np.int64)
    else:
        raise ValueError(f"unknown length law {law['law']!r}")
    return src, src.copy()


def bucket_plan(mix: dict):
    """[(T, B, batches, src lengths, tgt lengths)] of the pool: every
    bucket's share of `pool_batches` and the lengths of its pairs, in the
    order the mix's own `sizes_seed` drew them."""
    buckets = sorted((int(t), int(b)) for t, b in mix["buckets"])
    rng = np.random.default_rng(mix["sizes_seed"])
    src, tgt = _lengths(mix["source_length"], rng, mix["population"])
    longest = np.maximum(src, tgt)
    edges = np.array([t for t, _ in buckets])
    which = np.searchsorted(edges, longest)  # the smallest T >= both sides
    if (which >= len(buckets)).any():
        raise ValueError("a pair is longer than the largest bucket")
    tokens = np.array([(src + tgt)[which == i].sum() for i in range(len(buckets))], float)
    share = tokens / tokens.sum() * mix["pool_batches"]
    counts = np.maximum(np.floor(share).astype(int), 1)
    for i in np.argsort(-(share - np.floor(share))):  # largest remainders
        if counts.sum() >= mix["pool_batches"]:
            break
        counts[i] += 1
    plan = []
    for i, ((t, b), n) in enumerate(zip(buckets, counts)):
        rows = np.flatnonzero(which == i)[: n * b]
        if len(rows) < n * b:
            raise ValueError(f"population too small for bucket {t}: raise `population`")
        plan.append((t, b, int(n), src[rows], tgt[rows]))
    return plan


def _token_pairs(mix, cfg, seed, device):
    order = np.random.default_rng(derive(seed, "order"))
    gen = torch.Generator(device=device).manual_seed(derive(seed, "tokens"))
    vocab = cfg["vocab_size"]
    pool = []
    for t, b, n, src_len, tgt_len in bucket_plan(mix):
        perm = order.permutation(len(src_len))
        src_len, tgt_len = src_len[perm], tgt_len[perm]
        cols = torch.arange(t + 1, device=device)
        for j in range(n):
            ls = torch.as_tensor(src_len[j * b:(j + 1) * b], device=device)
            lt = torch.as_tensor(tgt_len[j * b:(j + 1) * b], device=device)
            src = torch.randint(1, vocab, (b, t), generator=gen, device=device)
            tgt = torch.randint(1, vocab, (b, t + 1), generator=gen, device=device)
            src = src.masked_fill(cols[None, :t] >= ls[:, None], 0)
            tgt = tgt.masked_fill(cols[None, :] > lt[:, None], 0)
            pool.append(Batch((src, tgt), int(tgt_len[j * b:(j + 1) * b].sum()), (b, t),
                              {"src": src_len[j * b:(j + 1) * b],
                               "tgt": tgt_len[j * b:(j + 1) * b], "t": t}))
    return [pool[i] for i in order.permutation(len(pool))]


def _images(mix, cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(derive(seed, "tokens"))
    b, h, w, c = mix["batch"], mix["height"], mix["width"], mix["channels"]
    pool = []
    for _ in range(mix["pool_batches"]):
        images = torch.rand(b, h, w, c, generator=gen, device=device)
        labels = torch.randint(0, mix["classes"], (b,), generator=gen, device=device)
        pool.append(Batch((images, labels), b, (b, h, w, c), {"hw": (h, w), "b": b}))
    return pool
