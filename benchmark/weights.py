"""Seeds and weights, made from the run's `--seed`.

Every random input of a run comes from one stream of its own, derived
from the seed and the stream's name, so the weights do not change when
the traffic does. Weights are drawn on the device in one call and handed
to the port (`load_state_dict`) and to the reference alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = ("weights", "tokens", "order")


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for `stream`, from any whole-number `seed`."""
    words = np.random.SeedSequence(seed % 2**64, spawn_key=(STREAMS.index(stream),)
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2**63 - 1)


def make_weights(spec, seed: int, device) -> dict:
    """The tensors of `spec` ((name, shape, init, trainable) rows) in
    float32 on `device`: `lecun` normal with variance 1 / fan-in (fan-in:
    every dimension but the first), `embed` normal with std 0.02, `zeros`
    and `ones`. The normals are one draw, split in `spec`'s order."""
    drawn = [(name, shape, init) for name, shape, init, _ in spec
             if init in ("lecun", "embed")]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape, init in drawn:
        n = math.prod(shape)
        std = 0.02 if init == "embed" else 1.0 / math.sqrt(math.prod(shape[1:]))
        out[name] = flat[offset:offset + n].view(shape).mul_(std)
        offset += n
    for name, shape, init, _ in spec:
        if init in ("zeros", "ones"):
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(shape, device=device)
        elif init not in ("lecun", "embed"):
            raise ValueError(f"{name}: unknown init {init!r}")
    return out
