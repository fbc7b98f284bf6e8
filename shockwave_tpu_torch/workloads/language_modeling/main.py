#!/usr/bin/env python3
"""LSTM LM / Wikitext-2 workload (trace: "LM (batch size N)"), on PyTorch.

The port of `shockwave_tpu/workloads/language_modeling/main.py`, with
the same CLI: the trace command is `python3 main.py --cuda --data
%s/wikitext2 --batch_size N` with `--steps` appended by the dispatcher.
`--device` (default `cuda`) chooses the card or, when asked, the CPU.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), *[".."] * 3))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from shockwave_tpu_torch.models import data  # noqa: E402
from shockwave_tpu_torch.models.lm import LSTMLanguageModel  # noqa: E402
from shockwave_tpu_torch.models.train_common import (  # noqa: E402
    Trainer, common_parser, parse_args, resolve_device)

MAX_BS = 80


def loss_fn(model, tokens, targets):
    """Mean cross-entropy over every target token (each row starts from a
    zero carry, so a rank's rows need nothing of another's)."""
    logits = model(tokens)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    return loss, {"count": targets.numel()}


def build_trainer(argv=None):
    """The job's `Trainer` from the trace's CLI, built but not trained."""
    p = common_parser("LSTM LM on Wikitext-2", steps_args=("--steps",))
    p.add_argument("--data", default=None)
    p.add_argument("--batch_size", type=int, default=20)
    args = parse_args(p, argv)
    device = resolve_device(args.device)
    return Trainer(
        args, loss_fn, LSTMLanguageModel(generator=torch.Generator().manual_seed(0)),
        data.wikitext2(args.batch_size, data_dir=args.data), device=device,
        learning_rate=1.0, initial_bs=args.batch_size, max_bs=MAX_BS)


def main(argv=None):
    trainer = build_trainer(argv)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
