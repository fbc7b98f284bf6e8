#!/usr/bin/env python3
"""Transformer / Multi30k translation workload
(trace: "Transformer (batch size N)"), on PyTorch.

The port of `shockwave_tpu/workloads/translation/train.py`, with the same
CLI: the trace command is `python3 train.py -data %s/... -batch_size N
-proj_share_weight` with `-step` appended by the dispatcher. `--device`
(default `cuda`) chooses the card or, when asked, the CPU; flash
attention defaults to on for the card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), *[".."] * 3))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from shockwave_tpu_torch.models import data  # noqa: E402
from shockwave_tpu_torch.models.train_common import (  # noqa: E402
    Trainer, common_parser, parse_args, resolve_device)
from shockwave_tpu_torch.models.transformer import Seq2SeqTransformer  # noqa: E402


def loss_fn(model, src_tokens, tgt_tokens):
    """Masked cross-entropy over the non-pad target tokens; `count` is
    their number (a gang weights each rank's gradient by it)."""
    logits = model(src_tokens, tgt_tokens[:, :-1])
    targets = tgt_tokens[:, 1:]
    mask = (targets != 0).float()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1), reduction="none")
    count = mask.sum()
    loss = (losses * mask.reshape(-1)).sum() / count.clamp_min(1.0)
    return loss, {"count": count}


def build_trainer(argv=None):
    """The job's `Trainer` from the trace's CLI, built but not trained."""
    p = common_parser("Transformer on Multi30k", steps_args=("-step", "--step"))
    p.add_argument("-data", dest="data", default=None)
    p.add_argument("-batch_size", dest="batch_size", type=int, default=64)
    p.add_argument("-proj_share_weight", action="store_true")
    p.add_argument("--use_flash", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused CUDA attention (default: on for the card; "
                        "--no-use_flash forces the einsum path)")
    args = parse_args(p, argv)
    device = resolve_device(args.device)  # on the card: TF32 off
    use_flash = (device.type == "cuda") if args.use_flash is None else args.use_flash
    model = Seq2SeqTransformer(use_flash=use_flash,
                               generator=torch.Generator().manual_seed(0))
    return Trainer(
        args, loss_fn, model,
        data.multi30k(args.batch_size, tgt_len=33, data_dir=args.data),
        device=device, learning_rate=1e-3, initial_bs=args.batch_size,
        max_bs=128)


def main(argv=None):
    trainer = build_trainer(argv)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
