"""Input pipelines of the translation workload: a copy of the Multi30k
part of `shockwave_tpu/models/data.py` (`SyntheticBatches`,
`ArrayBatches`, `_load_multi30k`, `multi30k`).

numpy only, and kept byte-for-byte in behaviour: with the same seed the
synthetic batches are the JAX package's, src (B, 32) and tgt (B, 33)
int32 from `RandomState(0)`. The trainer moves them to the device.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


class SyntheticBatches:
    """A fixed-length epoch of host-generated batches.

    SWTPU_SYNTH_EPOCH_BATCHES overrides the epoch length."""

    synthetic = True

    def __init__(self, make_batch, batches_per_epoch: int, seed: int = 0):
        self._make_batch = make_batch
        override = int(os.environ.get("SWTPU_SYNTH_EPOCH_BATCHES", "0"))
        self._len = override if override > 0 else max(1, batches_per_epoch)
        rng = np.random.RandomState(seed)
        # One real batch, reused; keeps host CPU out of the hot loop.
        self._batch = make_batch(rng)

    def __len__(self):
        return self._len

    def __iter__(self):
        for _ in range(self._len):
            yield self._batch


class ArrayBatches:
    """An epoch over in-memory arrays, reshuffled each epoch. Partial
    trailing batches are dropped: every yielded batch has the full
    batch_size leading dim."""

    synthetic = False

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 seed: int = 0, shuffle: bool = True):
        self._arrays = arrays
        self._bs = batch_size
        self._rng = np.random.RandomState(seed)
        self._shuffle = shuffle
        self._n = arrays[0].shape[0]
        if self._n < batch_size:
            raise ValueError(
                f"dataset has {self._n} samples < batch_size {batch_size}")

    def __len__(self):
        return self._n // self._bs

    def __iter__(self):
        order = (self._rng.permutation(self._n) if self._shuffle
                 else np.arange(self._n))
        for i in range(len(self)):
            idx = order[i * self._bs:(i + 1) * self._bs]
            yield tuple(a[idx] for a in self._arrays)


PAD, BOS, EOS, UNK = 0, 1, 2, 3


def _load_multi30k(data_dir: str, src_len: int, tgt_len: int,
                   vocab_cap: int) -> Optional[tuple]:
    """Read the raw Multi30k parallel files (train.de source -> train.en
    target). `data_dir` may be the directory itself, a file inside it
    (the trace passes a preprocessed .pt path; its directory is used), or
    a parent holding a multi30k/ subdir. Joint frequency-ranked vocab
    capped at `vocab_cap` with PAD/BOS/EOS/UNK reserved; src
    truncated+padded to src_len, tgt wrapped in BOS..EOS and padded to
    tgt_len."""
    if not os.path.isdir(data_dir):
        data_dir = os.path.dirname(data_dir)
    pair = None
    for cand in (data_dir, os.path.join(data_dir, "multi30k")):
        de, en = (os.path.join(cand, "train.de"), os.path.join(cand, "train.en"))
        if os.path.exists(de) and os.path.exists(en):
            pair = (de, en)
            break
    if pair is None:
        return None
    # Pair lines positionally first, then drop pairs with a blank side.
    with open(pair[0], encoding="utf-8") as f:
        src_raw = f.read().splitlines()
    with open(pair[1], encoding="utf-8") as f:
        tgt_raw = f.read().splitlines()
    pairs = [(s.lower().split(), t.lower().split())
             for s, t in zip(src_raw, tgt_raw) if s.strip() and t.strip()]
    if not pairs:
        return None
    src_lines = [s for s, _ in pairs]
    tgt_lines = [t for _, t in pairs]
    words = [w for ln in src_lines for w in ln]
    words += [w for ln in tgt_lines for w in ln]
    uniq, counts = np.unique(np.asarray(words), return_counts=True)
    keep = uniq[np.argsort(-counts, kind="stable")][: vocab_cap - 4]
    ids = {w: i + 4 for i, w in enumerate(keep)}

    def encode(lines, length, wrap):
        out = np.full((len(lines), length), PAD, np.int32)
        for r, ln in enumerate(lines):
            toks = [ids.get(w, UNK) for w in ln]
            if wrap:
                toks = [BOS] + toks[: length - 2] + [EOS]
            else:
                toks = toks[:length]
            out[r, : len(toks)] = toks
        return out

    return encode(src_lines, src_len, False), encode(tgt_lines, tgt_len, True)


def multi30k(batch_size: int, src_len: int = 32, tgt_len: int = 32,
             vocab: int = 9521, dataset_size: int = 10000, seed: int = 0,
             data_dir: Optional[str] = None):
    if data_dir:
        real = _load_multi30k(data_dir, src_len, tgt_len, vocab)
        if real is not None and real[0].shape[0] >= batch_size:
            return ArrayBatches(real, batch_size, seed)

    def make(rng):
        src = rng.randint(1, vocab, size=(batch_size, src_len)).astype(np.int32)
        tgt = rng.randint(1, vocab, size=(batch_size, tgt_len)).astype(np.int32)
        return src, tgt
    return SyntheticBatches(make, dataset_size // batch_size, seed)
