"""Input pipelines of the port's workloads: a copy of
`shockwave_tpu/models/data.py` for the families the port runs
(`SyntheticBatches`, `ArrayBatches`, `SparseRowBatches`,
`UnpairedBatches`, `LazyImageFolderBatches` and the loaders of CIFAR-10,
ImageNet, Multi30k, Wikitext-2, ML-20M and monet2photo).

numpy only, and kept byte-for-byte in behaviour: with the same seed the
synthetic batches are the JAX package's (tokens int32, images NHWC
float32, multi-hot rows float32), and the real-format loaders read the
same files into the same arrays. When no data directory is given or its
files are absent, deterministic synthetic batches of the right shapes
are made on the host. The trainer moves batches to the device.

Real formats supported per family:
  cifar10     pickled python batches (cifar-10-batches-py/) or cifar10.npz
  imagenet    train/<class>/ image folders, decoded lazily per batch
  wikitext2   wiki.train.tokens / train.txt word stream
  multi30k    train.de/train.en parallel sentence files
  ml20m       pro_sg/train.csv (uid,sid) interaction list
  monet2photo trainA/ + trainB/ image folders (PIL) or monet2photo.npz
"""
from __future__ import annotations

import os
import pickle
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


def _decode_image(path: str, size: int, scale: float,
                  offset: float) -> np.ndarray:
    """Decode one image file to (size, size, 3) float32 as
    pixel/scale + offset (classification: /255 in [0,1]; GAN tanh
    range: /127.5 - 1)."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size))
        return np.asarray(im, np.float32) / scale + offset


class SparseRowBatches:
    """Epochs of dense multi-hot rows densified per batch from per-row
    item-index lists. ML-20M's full user×item matrix is ~9 GB dense, so
    rows stay sparse on host and only each (batch, num_items) slab is
    materialized. Reshuffles each epoch; drops the partial tail batch."""

    synthetic = False

    def __init__(self, rows: Sequence[np.ndarray], num_items: int,
                 batch_size: int, seed: int = 0):
        if len(rows) < batch_size:
            raise ValueError(
                f"dataset has {len(rows)} rows < batch_size {batch_size}")
        self._rows = rows
        self._num_items = num_items
        self._bs = batch_size
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self._rows) // self._bs

    def __iter__(self):
        order = self._rng.permutation(len(self._rows))
        for i in range(len(self)):
            batch = np.zeros((self._bs, self._num_items), np.float32)
            for j, r in enumerate(order[i * self._bs:(i + 1) * self._bs]):
                batch[j, self._rows[r]] = 1.0
            yield (batch,)


class UnpairedBatches:
    """Two independently shuffled domains (CycleGAN A/B); each epoch
    yields min(len(A), len(B)) // batch_size unpaired (a, b) batches.
    Each domain is either an in-memory array or a list of image paths
    decoded lazily per batch (an epoch touches only min(len(A), len(B))
    images, so eagerly decoding a large domain would waste minutes and
    GBs at every lease re-dispatch)."""

    synthetic = False

    def __init__(self, a, b, batch_size: int, image_size: int = 128,
                 seed: int = 0):
        if min(len(a), len(b)) < batch_size:
            raise ValueError("domain smaller than batch_size")
        self._a, self._b = a, b
        self._bs = batch_size
        self._size = image_size
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return min(len(self._a), len(self._b)) // self._bs

    def _take(self, domain, idx):
        if isinstance(domain, np.ndarray):
            return domain[idx]
        out = np.empty((len(idx), self._size, self._size, 3), np.float32)
        for j, r in enumerate(idx):
            out[j] = _decode_image(domain[r], self._size, 127.5, -1.0)
        return out

    def __iter__(self):
        oa = self._rng.permutation(len(self._a))
        ob = self._rng.permutation(len(self._b))
        for i in range(len(self)):
            sl = slice(i * self._bs, (i + 1) * self._bs)
            yield self._take(self._a, oa[sl]), self._take(self._b, ob[sl])


def _load_cifar10(data_dir: str) -> Optional[tuple]:
    """Read CIFAR-10 from `data_dir`: either the standard pickled python
    batches (cifar-10-batches-py/data_batch_*) or a cifar10.npz with
    images/labels arrays. Returns (images NHWC float32 in [0,1], labels
    int32) or None when absent."""
    batch_dir = None
    for cand in (data_dir, os.path.join(data_dir, "cifar-10-batches-py")):
        if os.path.exists(os.path.join(cand, "data_batch_1")):
            batch_dir = cand
            break
    if batch_dir is not None:
        images, labels = [], []
        for i in range(1, 6):
            with open(os.path.join(batch_dir, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            images.append(np.asarray(d[b"data"], np.uint8))
            labels.append(np.asarray(d[b"labels"], np.int64))
        x = np.concatenate(images).reshape(-1, 3, 32, 32)
        x = x.transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        y = np.concatenate(labels).astype(np.int32)
        return x, y
    npz = os.path.join(data_dir, "cifar10.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        x = np.asarray(d["images"], np.float32)
        if x.max() > 1.5:
            x = x / 255.0
        return x, np.asarray(d["labels"], np.int32)
    return None


def cifar10(batch_size: int, data_dir: Optional[str] = None,
            dataset_size: int = 50000, seed: int = 0):
    if data_dir:
        real = _load_cifar10(data_dir)
        if real is not None and real[0].shape[0] >= batch_size:
            return ArrayBatches(real, batch_size, seed)

    def make(rng):
        return (rng.rand(batch_size, 32, 32, 3).astype(np.float32),
                rng.randint(0, 10, size=(batch_size,)).astype(np.int32))
    return SyntheticBatches(make, dataset_size // batch_size, seed)


class LazyImageFolderBatches:
    """ImageFolder-style epochs decoded lazily per batch: train/<class>/
    image files, label = class-dir index. The full dataset never sits in
    RAM (ImageNet is ~150 GB decoded) — only each (batch, size, size, 3)
    slab, matching the torchvision ImageFolder+DataLoader behavior the
    reference relies on. Shuffles each epoch; drops the partial tail."""

    synthetic = False

    def __init__(self, files: Sequence[str], labels: np.ndarray,
                 batch_size: int, image_size: int = 224, seed: int = 0):
        if len(files) < batch_size:
            raise ValueError(
                f"dataset has {len(files)} images < batch_size {batch_size}")
        self._files = files
        self._labels = labels
        self._bs = batch_size
        self._size = image_size
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self._files) // self._bs

    def __iter__(self):
        order = self._rng.permutation(len(self._files))
        for i in range(len(self)):
            idx = order[i * self._bs:(i + 1) * self._bs]
            batch = np.empty((self._bs, self._size, self._size, 3),
                             np.float32)
            for j, r in enumerate(idx):
                batch[j] = _decode_image(self._files[r], self._size,
                                         255.0, 0.0)
            yield batch, self._labels[idx].astype(np.int32)


def _scan_image_folder(data_dir: str) -> Optional[tuple]:
    """(files, labels) from a train/<class>/* tree (or <class>/* directly
    under data_dir). Returns None when no class dirs with images exist."""
    try:
        from PIL import Image  # noqa: F401 - decoding needs PIL later
    except ImportError:
        return None
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    for root in (os.path.join(data_dir, "train"), data_dir):
        if not os.path.isdir(root):
            continue
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        files, labels = [], []
        for ci, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith(exts):
                    files.append(os.path.join(cdir, name))
                    labels.append(ci)
        if files:
            return files, np.asarray(labels, np.int64)
    return None


def imagenet(batch_size: int, dataset_size: int = 100000, seed: int = 0,
             data_dir: Optional[str] = None):
    if data_dir:
        scanned = _scan_image_folder(data_dir)
        if scanned is not None and len(scanned[0]) >= batch_size:
            return LazyImageFolderBatches(scanned[0], scanned[1], batch_size,
                                          seed=seed)

    def make(rng):
        return (rng.rand(batch_size, 224, 224, 3).astype(np.float32),
                rng.randint(0, 1000, size=(batch_size,)).astype(np.int32))
    return SyntheticBatches(make, dataset_size // batch_size, seed)


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


def _load_wikitext2(data_dir: str, seq_len: int,
                    vocab_cap: int) -> Optional[tuple]:
    """Read wikitext-2 word-level LM windows from `data_dir`
    (wiki.train.tokens or train.txt). Builds a frequency-ranked vocab
    capped at `vocab_cap` (rarer words -> <unk>=0) and slices the token
    stream into (seq_len + 1)-long windows, reference-style batchify
    (word_language_model/data.py)."""
    path = None
    for cand in ("wiki.train.tokens", "train.txt",
                 os.path.join("wikitext-2", "wiki.train.tokens")):
        full = os.path.join(data_dir, cand)
        if os.path.exists(full):
            path = full
            break
    if path is None:
        return None
    with open(path, encoding="utf-8") as f:
        words = f.read().split()
    uniq, counts = np.unique(np.asarray(words), return_counts=True)
    keep = uniq[np.argsort(-counts, kind="stable")][: vocab_cap - 1]
    ids = {w: i + 1 for i, w in enumerate(keep)}  # 0 = <unk>
    stream = np.fromiter((ids.get(w, 0) for w in words), np.int32,
                         count=len(words))
    n_windows = (len(stream) - 1) // (seq_len + 1)
    if n_windows == 0:
        return None
    windows = stream[: n_windows * (seq_len + 1)].reshape(
        n_windows, seq_len + 1)
    return (windows[:, :-1], windows[:, 1:])


def wikitext2(batch_size: int, seq_len: int = 35, vocab: int = 33278,
              dataset_size: int = 59675, seed: int = 0,
              data_dir: Optional[str] = None):
    if data_dir:
        real = _load_wikitext2(data_dir, seq_len, vocab)
        if real is not None and real[0].shape[0] >= batch_size:
            return ArrayBatches(real, batch_size, seed)

    def make(rng):
        tokens = rng.randint(1, vocab, size=(batch_size, seq_len + 1)).astype(np.int32)
        return tokens[:, :-1], tokens[:, 1:]
    return SyntheticBatches(make, dataset_size // batch_size, seed)


def _list_image_domain(folder: str) -> Optional[list]:
    """Sorted image paths in `folder`; decoding happens per batch in
    UnpairedBatches (float32 in [-1, 1], CycleGAN's tanh range)."""
    if not os.path.isdir(folder):
        return None
    try:
        from PIL import Image  # noqa: F401 - decoding needs PIL later
    except ImportError:
        return None
    exts = (".jpg", ".jpeg", ".png")
    names = sorted(n for n in os.listdir(folder)
                   if n.lower().endswith(exts))
    if not names:
        return None
    return [os.path.join(folder, n) for n in names]


def _load_monet2photo(data_dir: str, image_size: int) -> Optional[tuple]:
    """trainA/ (paintings) + trainB/ (photos) folders (lazy path lists),
    or monet2photo.npz with A/B arrays."""
    for cand in (data_dir, os.path.join(data_dir, "monet2photo")):
        a = _list_image_domain(os.path.join(cand, "trainA"))
        b = _list_image_domain(os.path.join(cand, "trainB"))
        if a is not None and b is not None:
            return a, b
        npz = os.path.join(cand, "monet2photo.npz")
        if os.path.exists(npz):
            d = np.load(npz)
            a, b = np.asarray(d["A"], np.float32), np.asarray(d["B"], np.float32)
            if a.max() > 1.5:  # stored as uint8 range
                a, b = a / 127.5 - 1.0, b / 127.5 - 1.0
            a, b = (_resize_domain(x, image_size) for x in (a, b))
            return a, b
    return None


def _resize_domain(x: np.ndarray, image_size: int) -> np.ndarray:
    """Match stored images to the generators' (image_size, image_size)
    input; nearest-neighbor index resampling keeps numpy-only."""
    if x.shape[1] == image_size and x.shape[2] == image_size:
        return x
    ih = (np.arange(image_size) * x.shape[1] // image_size)
    iw = (np.arange(image_size) * x.shape[2] // image_size)
    return np.ascontiguousarray(x[:, ih][:, :, iw])


def monet2photo(batch_size: int, image_size: int = 128,
                dataset_size: int = 1193, seed: int = 0,
                data_dir: Optional[str] = None):
    """Unpaired image batches for CycleGAN (domains A=paintings, B=photos)."""
    if data_dir:
        real = _load_monet2photo(data_dir, image_size)
        if real is not None and min(len(real[0]),
                                    len(real[1])) >= batch_size:
            return UnpairedBatches(real[0], real[1], batch_size,
                                   image_size=image_size, seed=seed)

    def make(rng):
        a = (rng.rand(batch_size, image_size, image_size, 3) * 2 - 1)
        b = (rng.rand(batch_size, image_size, image_size, 3) * 2 - 1)
        return a.astype(np.float32), b.astype(np.float32)
    return SyntheticBatches(make, dataset_size // batch_size, seed)


def _load_ml20m(data_dir: str, num_items: int) -> Optional[list]:
    """Read the VAE-CF pro_sg interaction list: train.csv with a header
    and (uid, sid) integer rows. Items are frequency-ranked and capped at
    `num_items` (the model's output width); returns one sorted item-id
    array per user."""
    path = None
    for cand in (data_dir, os.path.join(data_dir, "pro_sg"),
                 os.path.join(data_dir, "ml-20m", "pro_sg")):
        full = os.path.join(cand, "train.csv")
        if os.path.exists(full):
            path = full
            break
    if path is None:
        return None
    try:
        # The real file is ~10M rows; np.loadtxt's C tokenizer parses it
        # in seconds, where genfromtxt's python loop takes minutes — and
        # jobs re-pay loader startup on every lease re-dispatch.
        pairs = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64,
                           usecols=(0, 1), ndmin=2)
    except Exception:  # noqa: BLE001 - malformed file -> synthetic fallback
        return None
    if pairs.shape[0] == 0:
        return None
    uids, sids = pairs[:, 0], pairs[:, 1]
    # Frequency-rank items so the cap keeps the most-interacted ones.
    uniq, inverse, counts = np.unique(sids, return_inverse=True,
                                      return_counts=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(-counts, kind="stable")] = np.arange(len(uniq))
    new_sid = rank[inverse]
    keep = new_sid < num_items
    uids, new_sid = uids[keep], new_sid[keep]
    order = np.argsort(uids, kind="stable")
    uids, new_sid = uids[order], new_sid[order]
    bounds = np.searchsorted(uids, np.unique(uids))
    rows = [np.sort(chunk.astype(np.int32))
            for chunk in np.split(new_sid, bounds[1:])]
    return [r for r in rows if r.size]


def ml20m(batch_size: int, num_items: int = 20108, dataset_size: int = 117907,
          seed: int = 0, data_dir: Optional[str] = None):
    if data_dir:
        rows = _load_ml20m(data_dir, num_items)
        if rows is not None and len(rows) >= batch_size:
            return SparseRowBatches(rows, num_items, batch_size, seed)

    def make(rng):
        # ~1% interaction density multi-hot rows.
        rows = (rng.rand(batch_size, num_items) < 0.01).astype(np.float32)
        return (rows,)
    return SyntheticBatches(make, dataset_size // batch_size, seed)
