"""The work that the attention kernels must do, and the least time it
can take on the card: the yardstick of `attn_roofline`.

`visible_scores` and `work` are frozen copies of `chip_smoke.py`'s, with
one change: the FLOPs count the visible (q, k) pairs of a key-padded
row, as the exponentials already did, not every key. Each input byte is
counted read once and each output byte written once; q, k, v, dO and
the outputs are of `esize` bytes, the row statistics (lse, delta) f32,
the key mask one byte a key.
"""
from __future__ import annotations

import torch

# The device kernels of one attention call, by their launch names'
# prefixes: K1 (the forward), the backward's delta, K2 (dQ), K3 (dK, dV).
KERNELS = ("flash_fwd", "flash_bwd_delta", "flash_dq", "flash_dkv")


def visible_scores(mask, b, h, tq, tk, causal, device):
    """The (q, k) scores that this mask and causality leave visible, over
    all (batch, head) pairs: the exponentials K1, K2 and K3 each need."""
    keys = mask if mask is not None else torch.ones(b, tk, dtype=torch.bool, device=device)
    if causal:  # row i sees the unmasked keys <= i
        return h * int(torch.cumsum(keys.int(), dim=1)[:, :tq].sum())
    return h * tq * int(keys.sum())


def work(b, tq, tk, h, d, causal, esize=2, visible=None):
    """(bytes, FLOPs, exponentials) each kernel must move, do and take:
    FLOPs and exponentials over the visible scores (`visible`, from the
    mask; by default every causal or full pair), none in delta."""
    bh = b * h
    pairs = tq * (tq + 1) // 2 if causal else tq * tk
    vis = bh * pairs if visible is None else visible
    q_bytes, kv_bytes = bh * tq * d * esize, bh * tk * d * esize
    row_bytes, mask_bytes = bh * tq * 4, b * tk
    return {
        "flash_bwd_delta": (2 * q_bytes + row_bytes, 2 * bh * tq * d, 0),
        "flash_fwd": (2 * q_bytes + 2 * kv_bytes + row_bytes + mask_bytes,
                      4 * vis * d, vis),
        "flash_dq": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes + mask_bytes,
                     6 * vis * d, vis),
        "flash_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes + mask_bytes,
                      8 * vis * d, vis),
    }


def prefix_mask(lengths, t: int) -> torch.Tensor:
    """(B, t) bool: True at the first `lengths[b]` positions of row b."""
    return torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]


def least_seconds(calls, rates) -> float:
    """The least time the four kernels of every call in `calls` can take:
    for each launch, the largest of its bytes over the memory rate, its
    FLOPs over the product rate and its exponentials over the exponential
    rate. `calls` holds (b, tq, tk, h, d, causal, key mask) rows; `rates`
    is (bytes/s, FLOP/s, exponentials/s)."""
    bytes_s, flops_s, exps_s = rates
    total = 0.0
    for b, tq, tk, h, d, causal, mask in calls:
        visible = visible_scores(mask, b, h, tq, tk, causal, "cpu")
        for nbytes, flops, exps in work(b, tq, tk, h, d, causal, visible=visible).values():
            total += max(nbytes / bytes_s, flops / flops_s, exps / exps_s)
    return total
